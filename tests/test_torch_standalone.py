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
                 "ops/fdct.py"):
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
