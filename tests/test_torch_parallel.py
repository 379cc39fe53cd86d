"""The port's multi-device layer against the JAX package's, on the CPU:
split_gops, GOPParallelDecoder over two CPU workers against the serial
decode of both packages, the sharded H.264 reconstruction step over
["cpu", "cpu"] against the JAX step and recon_h264_jit frame by frame,
and the port's entry / dryrun_multichip against `__graft_entry__`'s.

Inputs are the JAX tests' (tests/test_parallel.py `_encode_stream`, the
JAX encoders on a seeded texture; `__graft_entry__._multichip_inputs`).
Frames and planes must be np.array_equal, GOP splits and the coded-bit
statistic equal.
"""

import sys
import threading

import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from libav_tpu.avutil.frame import Packet as JPacket
from libav_tpu.codecs import api as jax_api
from libav_tpu.codecs.h264.device import recon_h264_jit
from libav_tpu.parallel import gop as jax_gop
from libav_tpu_torch import _kernels, entry
from libav_tpu_torch import parallel
from libav_tpu_torch.avutil.frame import Packet
from libav_tpu_torch.codecs import api as port_api
from libav_tpu_torch.parallel import gop
from test_parallel import _encode_stream

CPUS = ["cpu", "cpu"]


@pytest.fixture(autouse=True)
def _one_thread():
    # Tier-1 runs 6 xdist workers on 8 CPUs
    torch.set_num_threads(1)


def host_planes(frames):
    return [[np.asarray(p) for p in f.to_host().planes] for f in frames]


def assert_frames_equal(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert len(g) == len(w) == 3
        assert all(np.array_equal(a, b) for a, b in zip(g, w))


# ---------------------------------------------------------------------- #
# split_gops and GOPParallelDecoder
# ---------------------------------------------------------------------- #

@pytest.mark.parametrize("codec,datas", [
    ("h264", [b"\x00\x00\x01\x41", b"\x00\x00\x01\x65", b"\x00\x00\x01\x41",
              b"\x00\x00\x00\x01\x65", b"", b"\x00\x00\x01\x41"]),
    ("mpeg2video", [b"\x00\x00\x01\x00", b"\x00\x00\x01\xb3..",
                    b"\x00\x00\x01\x00", b"\x00\x00\x01\xb8..",
                    b"\x00\x00\x01\x00"]),
    ("mpeg4", [b"\x00\x00\x01\xb6\x40", b"\x00\x00\x01\x20..\x00\x00\x01"
               b"\xb6\x40", b"\x00\x00\x01\xb6\x00", b"\x00\x00\x01\xb6\x80"]),
])
def test_split_gops_matches_jax(codec, datas):
    """Segment boundaries at keyframes; packets before the first key form
    their own leading segment, as in the JAX scheduler."""
    got = gop.split_gops([Packet(data=d) for d in datas], codec)
    want = jax_gop.split_gops([JPacket(data=d) for d in datas], codec)
    assert [[p.data for p in g] for g in got] == \
        [[p.data for p in g] for g in want]
    assert len(got) >= 2


@pytest.mark.parametrize("codec,opts", [
    ("h264", {"qp": 30}),
    ("mpeg1video", {}),
])
def test_gop_parallel_matches_serial(codec, opts):
    """GOPParallelDecoder over two CPU workers on a REAL bitstream ==
    the port's serial decode == the JAX serial decode, frame order
    preserved (tests/test_parallel.py:55)."""
    pkts = _encode_stream(codec, 6, gop_size=2, **opts)
    datas = [p.data for p in pkts]
    gops = gop.split_gops([Packet(data=d) for d in datas], codec)
    assert len(gops) >= 3 and sum(map(len, gops)) == len(datas)
    par = port_api.CodecParameters(codec_type="video", codec_id=codec)
    serial = port_api.find_decoder(codec)(par, device="cpu").open() \
        .decode_all([Packet(data=d) for d in datas])
    dec = gop.GOPParallelDecoder(codec, devices=CPUS)
    assert dec.devices == [torch.device("cpu")] * 2 and dec.max_workers == 2
    parallel_frames = dec.decode([Packet(data=d) for d in datas])
    want = jax_api.find_decoder(codec)(jax_api.CodecParameters(
        codec_type="video", codec_id=codec)).open().decode_all(list(pkts))
    assert all(isinstance(p, np.ndarray) for f in parallel_frames
               for p in f.planes)
    assert_frames_equal(host_planes(parallel_frames), host_planes(serial))
    assert_frames_equal(host_planes(serial), host_planes(want))
    assert [f.pts for f in parallel_frames] == [f.pts for f in serial]


def test_gop_parallel_devices():
    """No fallback: without CUDA the default device list raises; an
    unknown device is refused; one GOP decodes on the first device."""
    with pytest.raises(ValueError):
        gop.GOPParallelDecoder("h264", devices=["meta"])
    assert gop.GOPParallelDecoder("h264", devices=CPUS).decode([]) == []
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        gop.GOPParallelDecoder("h264")
    with pytest.raises(RuntimeError, match="CUDA"):
        gop.GOPParallelDecoder("h264", devices=["cuda:0"])
    with pytest.raises(RuntimeError, match="CUDA"):
        parallel.make_mesh(2)


def test_count_launch_under_threads():
    """The kernels' launch counters lose no update when decoder threads
    launch at once: more threads than cores, a short switch interval."""
    class Wrapper:
        launches = 0
    n_threads, per = 16, 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [
            _kernels.count_launch(Wrapper) for _ in range(per)])
            for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert Wrapper.launches == n_threads * per


# ---------------------------------------------------------------------- #
# the sharded reconstruction step, entry and the dry run
# ---------------------------------------------------------------------- #

def test_shard_batch_and_replicate():
    a = np.arange(4 * 3 * 2, dtype=np.int32).reshape(4, 3, 2)
    shards = parallel.shard_batch(CPUS, a)
    assert [tuple(s.shape) for s in shards] == [(2, 3, 2)] * 2
    assert np.array_equal(torch.cat(shards).numpy(), a)
    assert shards[0].dtype == torch.int32
    cols = parallel.shard_batch(CPUS, a, batch_axis=2)
    assert np.array_equal(torch.cat(cols, dim=2).numpy(), a)
    with pytest.raises(ValueError, match="split"):
        parallel.shard_batch(CPUS, a[:3])
    reps = parallel.replicate(CPUS, a)
    assert all(np.array_equal(r.numpy(), a) for r in reps)
    a[0, 0, 0] = -1                     # uploads are copies
    assert int(reps[0][0, 0, 0]) == 0


def test_sharded_recon_step_matches_jax():
    """The port's step over ["cpu", "cpu"] on `_multichip_inputs(2, 4,
    3)`: each frame equals recon_h264_jit's, the planes equal the JAX
    sharded step's on a one-device mesh, and the coded-bit statistic
    equals its psum."""
    from libav_tpu.parallel import make_mesh as jax_make_mesh
    from libav_tpu.parallel import sharded_h264_recon_step as jax_step
    mb_w, mb_h = 4, 3
    args = graft._multichip_inputs(2, mb_w, mb_h)
    mine = entry.multichip_inputs(2, mb_w, mb_h)
    assert len(mine) == len(args)
    for a, b in zip(mine, args):
        assert a.dtype == np.asarray(b).dtype
        assert np.array_equal(a, np.asarray(b))
    step, shard_inputs = parallel.sharded_h264_recon_step(CPUS, mb_w, mb_h)
    (ys, us, vs), bits = step(*shard_inputs(args))
    assert [tuple(y.shape) for y in ys] == [(2, mb_h * 16, mb_w * 16)] * 2
    got = [np.concatenate([t.numpy() for t in p]) for p in (ys, us, vs)]
    recon = recon_h264_jit(mb_w, mb_h, True, 1)
    for b in range(args[0].shape[0]):
        (y1, u1, v1), _ = recon(*(a[b] for a in args))
        for g, w in zip((got[0][b], got[1][b], got[2][b]), (y1, u1, v1)):
            assert np.array_equal(g, np.asarray(w))
    mesh = jax_make_mesh(1)
    jstep, jshard = jax_step(mesh, mb_w, mb_h)
    with mesh:
        (jy, ju, jv), jbits = jstep(*jshard(args))
    for g, w in zip(got, (jy, ju, jv)):
        assert np.array_equal(g, np.asarray(w))
    assert bits.dtype == torch.int64 and int(bits) == int(jbits)


def test_entry_matches_jax():
    """entry("cpu") -> the same 8x6-MB recon as __graft_entry__.entry()."""
    fn, args = entry.entry("cpu")
    jfn, jargs = graft.entry()
    assert len(args) == len(jargs)
    for a, b in zip(args, jargs):
        assert np.array_equal(a.numpy(), np.asarray(b))
    got = fn(*args)
    want = jfn(*jargs)
    assert len(got) == 3
    for g, w in zip(got, want):
        assert g.dtype == torch.uint8
        assert np.array_equal(g.numpy(), np.asarray(w))


def test_dryrun_multichip_cpu():
    """The port's dry run over two CPU copies: the sharded step against
    the single-device recon, then the GOP-parallel decode of the JAX dry
    run's stream against the serial decode; the stream equals the JAX
    encoder's."""
    out = entry.dryrun_multichip(2, "cpu")
    assert out == {"devices": ["cpu", "cpu"], "batch": 4,
                   "bits": out["bits"], "gops": 3, "frames": 6}
    args = graft._multichip_inputs(2, 4, 3)
    assert out["bits"] == int(np.abs(args[6]).astype(np.int64).sum() +
                              np.abs(args[8]).astype(np.int64).sum())
    port = [p.data for p in entry.gop_stream("cpu")]
    jenc = jax_api.find_encoder("h264")(jax_api.CodecParameters(
        codec_type="video", codec_id="h264", width=48, height=32))
    jenc.set_opt("gop_size", 2)
    jenc.set_opt("qp", 30)
    jenc.open()
    from libav_tpu.avutil.frame import Frame as JFrame
    rng = np.random.default_rng(7)
    base = rng.integers(16, 235, (48, 48)).astype(np.uint8)
    frames = []
    for t in range(6):
        fl = np.roll(base, t * 2, axis=1)
        f = JFrame(width=48, height=32, format="yuv420p")
        f.planes = [fl[:32].copy(), fl[32:40].reshape(16, 24).copy(),
                    fl[40:].reshape(16, 24).copy()]
        f.pts = t
        frames.append(f)
    assert port == [p.data for p in jenc.encode_all(frames)]
