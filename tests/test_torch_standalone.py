"""The port stands alone: no module of `libav_tpu_torch` (nor
`chip_smoke.py`) imports jax, jaxlib or the JAX package `libav_tpu`, and
with all three refused at import the port's avconv and avprobe on the CPU
write what the JAX CLI writes, byte for byte.

`IMPORT_GUARD` is the refusing finder as source, for the subprocess tests
of the other test_torch_* files; chip_smoke.py installs the same finder
before it imports the port.
"""

import ast
import glob
import json
import os
import subprocess
import sys

import pytest

from libav_tpu.tools import avconv as jax_avconv
from libav_tpu.tools import avprobe as jax_avprobe
from test_torch_tools import _framecrc, _probe, inputs  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFUSED = ("jax", "jaxlib", "libav_tpu")

IMPORT_GUARD = f"""
import importlib.abc, sys


class _RefuseJax(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in {REFUSED!r}:
            raise ModuleNotFoundError(f"import of {{name}} refused")
        return None


sys.meta_path.insert(0, _RefuseJax())
sys.path.insert(0, {REPO!r})
"""

SOURCES = sorted(os.path.relpath(p, REPO) for p in
                 glob.glob(os.path.join(REPO, "libav_tpu_torch", "**",
                                        "*.py"), recursive=True)) + \
    ["chip_smoke.py"]


def imported_modules(path: str):
    """Every module name an import statement of the file names, at any
    depth (function bodies included)."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("source", SOURCES)
def test_source_imports_no_jax_package(source):
    bad = [m for m in imported_modules(os.path.join(REPO, source))
           if m.split(".")[0] in REFUSED]
    assert bad == []


def test_sources_cover_the_port():
    """The scan is a glob, not a list: every module of the port is in it,
    those of each slice included."""
    assert len(SOURCES) > 40
    for path in ("codecs/h264/dec.py", "codecs/mpeg4/enc.py",
                 "codecs/mpeg4/dec.py", "codecs/mpeg4/tables.py",
                 "codecs/trellis.py", "codecs/ratecontrol.py",
                 "avutil/eval.py", "formats/m4v.py", "ops/me.py",
                 "ops/fdct.py", "ops/gmc.py", "ops/mecmp.py", "ops/mc.py",
                 "ops/quant.py", "codecs/parsers.py", "codecs/er.py"):
        assert "libav_tpu_torch/" + path in SOURCES
    on_disk = glob.glob(os.path.join(REPO, "libav_tpu_torch", "*", "*.py"))
    assert len(SOURCES) > len(on_disk)
    assert not os.path.exists(os.path.join(REPO, "libav_tpu_torch",
                                           "hostcode.py"))


def test_cli_with_jax_package_refused(inputs, tmp_path):  # noqa: F811
    """The port's avconv (H.264, MPEG-2, both MJPEG inputs) and avprobe
    in a process where jax and libav_tpu cannot be imported: framecrc
    and probe text equal the JAX CLI's in this process."""
    names = ("h264", "m2v", "yuvj420p", "yuvj422p")
    want = {name: _framecrc(jax_avconv, inputs[name],
                            str(tmp_path / f"{name}.jax"))
            for name in names}
    want["probe"] = _probe(jax_avprobe, ["-show_frames", inputs["m2v"]])
    code = IMPORT_GUARD + f"""
import contextlib, io, json
import torch
torch.set_num_threads(1)
from libav_tpu_torch.tools import avconv, avprobe
out = {{}}
for name, src in {[(n, inputs[n]) for n in names]!r}:
    dst = name + ".crc"
    assert avconv.main(["-i", src, "-f", "framecrc", dst], device="cpu") == 0
    out[name] = open(dst).read()
text = io.StringIO()
with contextlib.redirect_stdout(text):
    assert avprobe.main(["-show_frames", {inputs["m2v"]!r}],
                        device="cpu") == 0
out["probe"] = text.getvalue()
loaded = sorted(m for m, v in sys.modules.items() if v is not None
                and m.split(".")[0] in {REFUSED!r})
assert loaded == [], loaded
print(json.dumps(out))
"""
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600, cwd=str(tmp_path))
    assert r.returncode == 0, r.stderr[-3000:]
    assert json.loads(r.stdout.strip().splitlines()[-1]) == want


def test_transcode_with_jax_package_refused(inputs, tmp_path):  # noqa: F811
    """The port's avconv transcodes MPEG-2 to MPEG-4 in a process where
    jax and libav_tpu cannot be imported: the JAX CLI's bytes."""
    argv = ["-i", inputs["m2v"], "-c:v", "mpeg4", "-q:v", "6", "-g", "12",
            "-bf", "2", "-f", "m4v"]
    want = str(tmp_path / "jax.m4v")
    assert jax_avconv.main(argv + [want]) == 0
    code = IMPORT_GUARD + f"""
import torch
torch.set_num_threads(1)
from libav_tpu_torch.tools import avconv
assert avconv.main({argv!r} + ["port.m4v"], device="cpu") == 0
loaded = sorted(m for m, v in sys.modules.items() if v is not None
                and m.split(".")[0] in {REFUSED!r})
assert loaded == [], loaded
print("ok")
"""
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600, cwd=str(tmp_path))
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr[-3000:]
    with open(want, "rb") as f, open(tmp_path / "port.m4v", "rb") as g:
        assert g.read() == f.read()


def test_mpeg4_decode_with_jax_package_refused(tmp_path):
    """The port decodes an MPEG-4 ASP stream (qpel, mpegq, GMC with B-VOPs,
    data partitioning) through its avconv in a process where jax and
    libav_tpu cannot be imported: the JAX CLI's framecrc."""
    from tools.gen_torch_smoke_stream import encode_mpeg4, pattern
    runs = {"qpel": {"qpel": 1, "mpegq": 1, "acpred": 1},
            "gmc": {"gmc": 3, "b_frames": 2},
            "dp": {"ps": 80, "data_partitioning": 1, "mbcmp": "satd"}}
    want = {}
    for name, settings in runs.items():
        datas, _ = encode_mpeg4([pattern(64, 48, t) for t in range(4)],
                                settings)
        with open(tmp_path / f"{name}.m4v", "wb") as f:
            f.write(b"".join(datas))
        want[name] = _framecrc(jax_avconv, str(tmp_path / f"{name}.m4v"),
                               str(tmp_path / f"{name}.jax"))
    code = IMPORT_GUARD + f"""
import json
import torch
torch.set_num_threads(1)
from libav_tpu_torch.tools import avconv
out = {{}}
for name in {sorted(runs)!r}:
    assert avconv.main(["-i", name + ".m4v", "-f", "framecrc",
                        name + ".crc"], device="cpu") == 0
    out[name] = open(name + ".crc").read()
loaded = sorted(m for m, v in sys.modules.items() if v is not None
                and m.split(".")[0] in {REFUSED!r})
assert loaded == [], loaded
print(json.dumps(out))
"""
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600, cwd=str(tmp_path))
    assert r.returncode == 0, r.stderr[-3000:]
    assert json.loads(r.stdout.strip().splitlines()[-1]) == want


def test_guard_refuses(tmp_path):
    code = IMPORT_GUARD + """
for name in ("jax", "libav_tpu.avutil.error"):
    try:
        __import__(name)
    except ModuleNotFoundError:
        continue
    raise SystemExit(f"{name} was imported")
import libav_tpu_torch.avutil.error
print("ok")
"""
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, cwd=str(tmp_path))
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr[-2000:]


def test_sources_cover_the_config5_chain():
    for path in ("swscale/__init__.py", "swscale/bitexact.py",
                 "swscale/packing.py", "swscale/yuv2rgb.py",
                 "ops/fftmdct.py", "codecs/ac3/dec.py", "codecs/ac3/eac3.py",
                 "codecs/aac/dec.py", "codecs/aac/sbr.py", "codecs/aac/ps.py",
                 "avresample/__init__.py", "avresample/refexact.py",
                 "avresample/mixmatrix.py", "avresample/dither.py",
                 "formats/wav.py", "formats/pcmraw.py", "formats/ac3raw.py",
                 "formats/aacraw.py", "formats/yuv4mpeg.py"):
        assert "libav_tpu_torch/" + path in SOURCES
    assert os.path.exists(os.path.join(REPO, "libav_tpu_torch", "csrc",
                                       "sws_yuv2rgb.cu"))


def test_config5_cli_with_jax_package_refused(tmp_path):
    """The port's avconv runs the config-5 chain (AC-3 -> -ar 44100 -ac 2,
    H.264 -> -pix_fmt rgb24 and -s) in a process where jax and libav_tpu
    cannot be imported: the JAX CLI's bytes."""
    from libav_tpu_torch import testdata
    from tools.gen_torch_smoke_stream import audio_signal, encode_audio
    ac3 = str(tmp_path / "in.ac3")
    with open(ac3, "wb") as f:
        f.write(encode_audio("ac3", audio_signal(0.25, 5, 3),
                             {"bitrate_kbps": 384}))
    runs = {"ac3.raw": ["-i", ac3, "-ar", "44100", "-ac", "2", "-f",
                        "s16le"],
            "rgb.crc": ["-i", testdata.SMALL_H264, "-pix_fmt", "rgb24",
                        "-f", "framecrc"],
            "s.crc": ["-i", testdata.SMALL_H264, "-s", "48x32", "-f",
                      "framecrc"]}
    want = {}
    for name, argv in runs.items():
        assert jax_avconv.main(argv + [str(tmp_path / ("jax_" + name))]) == 0
        want[name] = (tmp_path / ("jax_" + name)).read_bytes()
    code = IMPORT_GUARD + f"""
import torch
torch.set_num_threads(1)
from libav_tpu_torch.tools import avconv
for name, argv in {runs!r}.items():
    assert avconv.main(argv + ["port_" + name], device="cpu") == 0
loaded = sorted(m for m, v in sys.modules.items() if v is not None
                and m.split(".")[0] in {REFUSED!r})
assert loaded == [], loaded
print("ok")
"""
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600, cwd=str(tmp_path))
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr[-3000:]
    for name in runs:
        assert (tmp_path / ("port_" + name)).read_bytes() == want[name]


def test_sources_cover_the_container_slice():
    """The container and audio-encode slice's modules are in the scan."""
    for path in ("codecs/ac3/enc.py", "codecs/aac/enc.py", "codecs/bsf.py",
                 "formats/mov.py", "formats/matroska.py", "formats/mpegts.py",
                 "codecs/mpegaudio/__init__.py", "codecs/mpegaudio/tables.py",
                 "codecs/mpegaudio/synth.py", "codecs/mpegaudio/layer3.py",
                 "codecs/mpegaudio/dec.py", "codecs/mpegaudio/enc.py",
                 "formats/mp3raw.py", "codecs/flac/__init__.py",
                 "codecs/flac/dec.py", "codecs/flac/enc.py",
                 "formats/flacfmt.py", "avutil/fifo.py", "ops/float_dsp.py",
                 "testdata/containers.py"):
        assert "libav_tpu_torch/" + path in SOURCES


def test_container_cli_with_jax_package_refused(tmp_path):
    """The port's avconv muxes the small H.264 stream with AAC into MP4,
    remuxes it with AC-3 into Matroska and MPEG-TS and encodes the AC-3
    to MP2 and FLAC, in a process where jax and libav_tpu cannot be
    imported: the JAX CLI's bytes."""
    from libav_tpu_torch import testdata
    from tools.gen_torch_smoke_stream import audio_signal, encode_audio
    x = audio_signal(0.3, 2, 8)
    aac, ac3 = str(tmp_path / "in.aac"), str(tmp_path / "in.ac3")
    with open(aac, "wb") as f:
        f.write(encode_audio("aac", x, {"quality": 10}))
    with open(ac3, "wb") as f:
        f.write(encode_audio("ac3", x, {"bitrate_kbps": 192}))
    runs = [("o.mp4", ["-i", testdata.SMALL_H264, "-i", aac, "-map", "0:0",
                       "-map", "1:0", "-c", "copy"]),
            ("o.mkv", ["-i", "o.mp4", "-i", ac3, "-map", "0:0", "-map",
                       "1:0", "-c", "copy"]),
            ("o.ts", ["-i", "o.mp4", "-i", ac3, "-map", "0:0", "-map",
                      "1:0", "-c", "copy"]),
            ("o.mp2", ["-i", ac3, "-c:a", "mp2"]),
            ("o.flac", ["-i", ac3, "-sample_fmt", "s16", "-c:a", "flac"])]
    want = {}
    for d, tool in (("jax", jax_avconv),):
        (tmp_path / d).mkdir()
        for name, argv in runs:
            args = [str(tmp_path / d / a) if a.startswith("o.") else a
                    for a in argv + [name]]
            assert tool.main(args) == 0
            want[name] = (tmp_path / d / name).read_bytes()
    code = IMPORT_GUARD + f"""
import torch
torch.set_num_threads(1)
from libav_tpu_torch.tools import avconv
for name, argv in {runs!r}:
    assert avconv.main(argv + [name], device="cpu") == 0
loaded = sorted(m for m, v in sys.modules.items() if v is not None
                and m.split(".")[0] in {REFUSED!r})
assert loaded == [], loaded
print("ok")
"""
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600, cwd=str(tmp_path))
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr[-3000:]
    for name, _ in runs:
        assert (tmp_path / name).read_bytes() == want[name], name


def test_sources_cover_the_filter_slice():
    """The filter graphs' modules are in the scan."""
    for path in ("filters/__init__.py", "filters/graph.py", "filters/vf.py",
                 "filters/af.py", "filters/src.py", "ops/yadif.py"):
        assert "libav_tpu_torch/" + path in SOURCES


def test_filter_cli_with_jax_package_refused(inputs, tmp_path):  # noqa: F811
    """The port's avconv runs -vf (yadif, the pixel filters), -af and
    -filter_complex in a process where jax and libav_tpu cannot be
    imported: the JAX CLI's bytes."""
    from libav_tpu_torch import testdata
    from tools.gen_torch_smoke_stream import audio_signal, encode_audio
    ac3 = str(tmp_path / "in.ac3")
    with open(ac3, "wb") as f:
        f.write(encode_audio("ac3", audio_signal(0.2, 2, 4),
                             {"bitrate_kbps": 192}))
    runs = {"yadif.crc": ["-i", inputs["m2v"], "-vf", "yadif=1", "-f",
                          "framecrc"],
            "vf.crc": ["-i", testdata.SMALL_H264, "-vf",
                       "crop=48:32,hqdn3d,unsharp,gradfun=1.2:8,hflip",
                       "-f", "framecrc"],
            "fc.crc": ["-i", testdata.SMALL_H264, "-i", testdata.SMALL_H264,
                       "-filter_complex", "[0:v][1:v]overlay=8:8", "-f",
                       "framecrc"],
            "af.raw": ["-i", ac3, "-af", "volume=0.5,aresample=44100", "-f",
                       "s16le"]}
    want = {}
    for name, argv in runs.items():
        assert jax_avconv.main(argv + [str(tmp_path / ("jax_" + name))]) == 0
        want[name] = (tmp_path / ("jax_" + name)).read_bytes()
    code = IMPORT_GUARD + f"""
import torch
torch.set_num_threads(1)
from libav_tpu_torch.tools import avconv
for name, argv in {runs!r}.items():
    assert avconv.main(argv + ["port_" + name], device="cpu") == 0
loaded = sorted(m for m, v in sys.modules.items() if v is not None
                and m.split(".")[0] in {REFUSED!r})
assert loaded == [], loaded
print("ok")
"""
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600, cwd=str(tmp_path))
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr[-3000:]
    for name in runs:
        assert (tmp_path / ("port_" + name)).read_bytes() == want[name], name
