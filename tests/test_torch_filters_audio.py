"""The port's audio filters (libav_tpu_torch/filters/af.py, host numpy
over the port's avresample) against the JAX package's, on the CPU.

The same seeded sample planes (s16, s16p, fltp, flt) go through both
packages' filter graphs; every output plane must equal the JAX filter's
(np.array_equal, tolerance 0), with the same sample count, timestamp,
rate, format and channel count. The DAG graphs of the JAX package's own
tests (asplit/amix, channelsplit/join) and an `-af` run of both CLIs are
held the same way.
"""

import numpy as np
import pytest

from libav_tpu.avutil.frame import Frame as JFrame
from libav_tpu.avutil.rational import Rational as JRational
from libav_tpu.filters.graph import FilterGraph as JGraph
from libav_tpu.filters.graph import get_filter as jget
from libav_tpu.tools import avconv as jax_avconv
from libav_tpu_torch.avutil.frame import Frame
from libav_tpu_torch.avutil.rational import Rational
from libav_tpu_torch.filters.graph import FilterGraph, get_filter
from libav_tpu_torch.tools import avconv

AUDIO_PROPS = ("nb_samples", "sample_rate", "format", "channels",
               "channel_layout", "pts")


def samples(fmt, n, channels, seed):
    """Seeded planes of one audio frame in fmt."""
    rng = np.random.default_rng(seed)
    x = np.sin(np.arange(n)[None, :] * (0.01 + 0.02 * np.arange(
        channels)[:, None])) * 0.6 + rng.normal(0, 0.05, (channels, n))
    if fmt.startswith("s16"):
        x = np.clip(np.round(x * 20000), -32768, 32767).astype(np.int16)
    elif fmt.startswith("s32"):
        x = np.round(x * 1e9).astype(np.int32)
    else:
        x = x.astype(np.float32)
    if fmt.endswith("p"):
        return [x[c].copy() for c in range(channels)]
    return [np.ascontiguousarray(x.T).ravel()]


def frames_of(fmt="s16", n=256, channels=2, count=3, rate=8000, seed=0,
              pts_step=None):
    pairs = []
    for i in range(count):
        planes = samples(fmt, n, channels, seed + i)
        pts = i * (pts_step or n)
        jf = JFrame(format=fmt, nb_samples=n, sample_rate=rate,
                    channels=channels, channel_layout=3 if channels == 2
                    else (4 if channels == 1 else 0), pts=pts)
        tf = Frame(format=fmt, nb_samples=n, sample_rate=rate,
                   channels=channels, channel_layout=jf.channel_layout,
                   pts=pts)
        jf.time_base = JRational(1, rate)
        tf.time_base = Rational(1, rate)
        jf.planes = [p.copy() for p in planes]
        tf.planes = [p.copy() for p in planes]
        pairs.append((jf, tf))
    return pairs


def assert_same(jouts, touts):
    assert len(touts) == len(jouts)
    for k, (jf, tf) in enumerate(zip(jouts, touts)):
        for name in AUDIO_PROPS:
            assert getattr(tf, name) == getattr(jf, name), (k, name)
        assert len(tf.planes) == len(jf.planes)
        for jp, tp in zip(jf.planes, tf.planes):
            a, b = np.asarray(jp), np.asarray(tp)
            assert a.dtype == b.dtype and a.shape == b.shape, k
            assert np.array_equal(a, b), k


def run_both(desc, pairs, capsys=None):
    """desc through both graphs -> (JAX frames, port frames); where the
    JAX graph raises, the port's must raise too (-> ([], []))."""
    try:
        jg = JGraph(desc)
        jouts = [o for jf, _ in pairs for o in jg.push(jf)] + jg.push_eof()
    except Exception:
        with pytest.raises(Exception):
            tg = FilterGraph(desc, device="cpu")
            for _, tf in pairs:
                tg.push(tf)
            tg.push_eof()
        return [], []
    jerr = capsys.readouterr().err if capsys else None
    tg = FilterGraph(desc, device="cpu")
    touts = [o for _, tf in pairs for o in tg.push(tf)] + tg.push_eof()
    if capsys:
        assert capsys.readouterr().err == jerr
    return jouts, touts


FORMATS = ("s16", "s16p", "fltp", "flt")


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("desc", [
    "anull", "afifo", "abuffer", "abuffersink", "asplit", "anullsink",
    "volume=0.5",
    "volume=3.7", "aresample=rate=44100", "aresample=rate=6000:fmt=fltp",
    "resample", "aformat=sample_fmts=fltp", "aformat=sample_fmts=s16",
    "aformat=sample_rates=16000", "atrim=start_sample=100:end_sample=600",
    "atrim=end_sample=256", "asetpts=PTS*2+N", "asettb=1/1000",
    "asettb=AVTB", "asettb=intb", "channelmap=map=1|0", "amix",
    "compand", "compand=attacks=0.01|0.02:decays=0.1|0.2:"
    "points=-80/-80|-30/-10|0/-3:soft-knee=6:gain=2",
    "compand=delay=0.01", "volume=0.8,aresample=rate=11025",
])
def test_audio_filter_matches_jax(desc, fmt):
    assert_same(*run_both(desc, frames_of(fmt)))


@pytest.mark.parametrize("fmt", ["s16", "fltp"])
def test_mono_audio_filters_match_jax(fmt):
    for desc in ("volume=2.5", "amix", "aresample=rate=22050"):
        assert_same(*run_both(desc, frames_of(fmt, channels=1)))


@pytest.mark.parametrize("pts_step,min_delta", [(400, 100), (200, 4),
                                                (250, 10), (256, 1)])
def test_asyncts_matches_jax(pts_step, min_delta):
    """Gaps filled with silence, overlaps dropped, small drift snapped."""
    for fmt in ("s16", "s16p"):
        pairs = frames_of(fmt, count=4, pts_step=pts_step)
        assert_same(*run_both(f"asyncts=min_delta={min_delta}", pairs))


def test_ashowinfo_matches_jax(capsys):
    for fmt in FORMATS:
        assert_same(*run_both("ashowinfo", frames_of(fmt), capsys))


# channelsplit reads planes[0] only: one plane holding every channel
@pytest.mark.parametrize("desc,fmt", [
    ("asplit[a][b];[a]anull[x];[b]anull[y];[x][y]amix", "s16"),
    ("asplit[a][b];[a]anull[x];[b]anull[y];[x][y]amix", "fltp"),
    ("asplit[a][b];[a]volume=0.5[x];[b]anull[y];[x][y]amix", "s16"),
    ("asplit[a][b];[a]volume=0.5[x];[b]anull[y];[x][y]amix", "fltp"),
    ("channelsplit[l][r];[l]anull[x];[r]anull[y];[x][y]join", "s16"),
    ("channelsplit[l][r];[l]volume=2[x];[r]anull[y];[x][y]join", "s16"),
    ("channelsplit[l][r];[l]anull[x];[r]anull[y];[x][y]join", "flt"),
    ("asplit[a][b];[a]anull[x];[b]anullsink;[x]anull", "s16"),
])
def test_audio_dag_matches_jax(desc, fmt):
    assert_same(*run_both(desc, frames_of(fmt)))


def test_join_push_secondary_matches_jax():
    """join fed through push_secondary, as in the JAX package's test."""
    want, got = [], []
    for g, out, f in ((JGraph("join=inputs=2"), want, 0),
                      (FilterGraph("join=inputs=2", device="cpu"), got, 1)):
        pairs = frames_of("s16", channels=1, count=2, seed=5)
        g.filters[0].push_secondary(pairs[1][f])
        out += g.push(pairs[0][f])
    assert_same(want, got)


def test_channelsplit_pads_match_jax():
    pairs = frames_of("s16", n=4, count=1)
    want = jget("channelsplit")("").filter_frame(pairs[0][0])
    got = get_filter("channelsplit")("", device="cpu").filter_frame(
        pairs[0][1])
    assert_same(want, got)


def test_anullsrc_matches_jax():
    for args in ("", "sample_rate=8000:channel_layout=mono:nb_samples="
                     "160:duration=3"):
        assert_same(list(jget("anullsrc")(args).generate()),
                    list(get_filter("anullsrc")(args, device="cpu")
                         .generate()))


@pytest.mark.parametrize("af", ["volume=0.5", "volume=0.5,aresample=44100",
                                "atrim=end_sample=3000,volume=2"])
def test_avconv_af_matches_jax(af, tmp_path):
    """-af through both CLIs on a WAV written by the JAX CLI: the same
    s16le bytes."""
    from libav_tpu.formats import wav  # noqa: F401
    src = str(tmp_path / "in.wav")
    x = samples("s16", 4800, 2, 3)[0]
    raw = str(tmp_path / "in.raw")
    x.tofile(raw)
    assert jax_avconv.main(["-f", "s16le", "-ar", "48000", "-ac", "2",
                            "-i", raw, src]) == 0
    out = {}
    for name, tool, kw in (("jax", jax_avconv, {}),
                           ("port", avconv, {"device": "cpu"})):
        dst = str(tmp_path / f"{name}.raw")
        assert tool.main(["-i", src, "-af", af, "-f", "s16le", dst],
                         **kw) == 0
        with open(dst, "rb") as f:
            out[name] = f.read()
    assert out["port"] == out["jax"] and len(out["jax"]) > 1000
