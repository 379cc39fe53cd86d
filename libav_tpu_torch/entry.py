"""The port's counterparts of the driver entry points in
`__graft_entry__.py` (`entry`, `dryrun_multichip`).

entry(device)      -> (fn, args): the flagship single-device step, the
                      H.264 whole-frame device reconstruction (batched
                      dequant/IDCT + qpel MC + wavefront intra assembly)
                      on 8x6 MBs, its inputs built from
                      np.random.default_rng(0) exactly as the JAX entry
                      builds them, then uploaded to device.
dryrun_multichip(n, device)
                   -> the sharded reconstruction step
                      (parallel.sharded_h264_recon_step) over n copies of
                      device, held frame by frame against the
                      single-device recon; then GOPParallelDecoder on a
                      multi-GOP H.264 stream held against the serial
                      decode.

One process drives every device; nothing here uses torch.distributed.
The device is "cuda" unless the caller names "cpu".
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from libav_tpu_torch.avutil import hwdevice


def entry(device="cuda"):
    """Flagship single-device step: the H.264 device reconstruction
    program (codecs/h264/device.recon_h264) on a small frame geometry."""
    from libav_tpu_torch.codecs.h264.device import recon_h264, \
        zero_refs_h264

    dev = hwdevice.device(device)
    mb_w, mb_h = 8, 6
    nmb = mb_w * mb_h
    rng = np.random.default_rng(0)

    fn = recon_h264(mb_w, mb_h, device=dev)
    refs = zero_refs_h264(mb_w, mb_h, device=dev)

    intra = rng.random(nmb) < 0.3
    args = hwdevice.state_from_numpy((
        intra,
        rng.integers(0, 4, nmb).astype(np.int32),        # luma mode
        rng.integers(0, 4, nmb).astype(np.int32),        # chroma mode
        rng.integers(-32, 33, (nmb, 2)).astype(np.int32),  # mv (qpel)
        np.full(nmb, 26, dtype=np.int32),                # qp
        rng.integers(-40, 41, (nmb, 16)).astype(np.int32),
        rng.integers(-40, 41, (nmb, 16, 16)).astype(np.int32),
        rng.integers(-20, 21, (nmb, 2, 4)).astype(np.int32),
        rng.integers(-20, 21, (nmb, 8, 16)).astype(np.int32),
    ), dev) + refs

    def step(*a):
        planes, padded = fn(*a)
        return planes

    return step, args


def multichip_inputs(n_devices: int, mb_w: int, mb_h: int):
    """Random-but-deterministic MB command arrays (host numpy) for a frame
    batch of B = 2*n_devices frames (independent GOP segments, SURVEY.md
    §2.10), as `__graft_entry__._multichip_inputs` builds them."""
    from libav_tpu_torch.ops.mc import EDGE

    nmb = mb_w * mb_h
    B = 2 * n_devices
    rng = np.random.default_rng(0)
    H, W = mb_h * 16, mb_w * 16
    y = np.full((H + 2 * EDGE, W + 2 * EDGE), 128, np.uint8)
    c = np.full((H // 2 + 2 * EDGE, W // 2 + 2 * EDGE), 128, np.uint8)
    refs = tuple(np.broadcast_to(p, (B,) + p.shape).copy()
                 for p in (y, c, c))
    return (
        rng.random((B, nmb)) < 0.3,
        rng.integers(0, 4, (B, nmb)).astype(np.int32),
        rng.integers(0, 4, (B, nmb)).astype(np.int32),
        rng.integers(-32, 33, (B, nmb, 2)).astype(np.int32),
        np.full((B, nmb), 26, dtype=np.int32),
        rng.integers(-40, 41, (B, nmb, 16)).astype(np.int32),
        rng.integers(-40, 41, (B, nmb, 16, 16)).astype(np.int32),
        rng.integers(-20, 21, (B, nmb, 2, 4)).astype(np.int32),
        rng.integers(-20, 21, (B, nmb, 8, 16)).astype(np.int32),
        *refs,
    )


def gop_stream(device, w: int = 48, h: int = 32, n: int = 6):
    """The dry run's multi-GOP H.264 stream: n frames of a seeded texture
    rolled 2 pixels a frame, GOP 2, qp 30, through the port's encoder on
    device (the JAX dry run's settings) -> packets."""
    from libav_tpu_torch.avutil.frame import Frame
    from libav_tpu_torch.codecs import find_encoder
    from libav_tpu_torch.codecs.api import CodecParameters, MediaType

    enc = find_encoder("h264")(CodecParameters(
        codec_type=MediaType.VIDEO, codec_id="h264", width=w, height=h),
        device=device)
    enc.set_opt("gop_size", 2)
    enc.set_opt("qp", 30)
    enc.open()
    rng = np.random.default_rng(7)
    base = rng.integers(16, 235, (h * 3 // 2, w)).astype(np.uint8)
    frames = []
    for t in range(n):
        fl = np.roll(base, t * 2, axis=1)
        f = Frame(width=w, height=h, format="yuv420p")
        f.planes = [fl[:h].copy(),
                    fl[h:h + h // 4].reshape(h // 2, w // 2).copy(),
                    fl[h + h // 4:].reshape(h // 2, w // 2).copy()]
        f.pts = t
        frames.append(f)
    return enc.encode_all(frames)


def dryrun_multichip(n_devices: int, device="cuda") -> Dict:
    """Run ONE sharded step of the real H.264 whole-frame reconstruction
    program over n_devices copies of device (frame batch split across
    them, the summed rate statistic), check it frame by frame against
    single-device reconstruction, then decode a multi-GOP stream
    GOP-parallel over the same devices against the serial decoder.
    Raises on any difference; -> a summary of what ran."""
    from libav_tpu_torch.codecs import find_decoder
    from libav_tpu_torch.codecs.api import CodecParameters, MediaType
    from libav_tpu_torch.codecs.h264.device import recon_h264
    from libav_tpu_torch.parallel import sharded_h264_recon_step
    from libav_tpu_torch.parallel.gop import GOPParallelDecoder, split_gops

    dev = hwdevice.device(device)
    devices = [dev] * n_devices
    mb_w, mb_h = 4, 3
    args = multichip_inputs(n_devices, mb_w, mb_h)
    B = args[0].shape[0]

    step, shard_inputs = sharded_h264_recon_step(devices, mb_w, mb_h)
    (ys, us, vs), bits = step(*shard_inputs(args))
    yp, up, vp = (np.concatenate([t.cpu().numpy() for t in p])
                  for p in (ys, us, vs))
    if yp.shape != (B, mb_h * 16, mb_w * 16) or \
            up.shape != (B, mb_h * 8, mb_w * 8):
        raise AssertionError(f"sharded step: planes {yp.shape}, {up.shape}")
    want_bits = int(np.abs(args[6]).astype(np.int64).sum() +
                    np.abs(args[8]).astype(np.int64).sum())
    if int(bits) != want_bits or bits.device != dev:
        raise AssertionError(f"sharded step: bits {int(bits)} on "
                             f"{bits.device}, want {want_bits} on {dev}")

    # correctness: the sharded batch must equal per-frame single-device
    # reconstruction exactly (integer pipeline -> bit-identical)
    recon = recon_h264(mb_w, mb_h, True, 1, device=dev)
    for b in range(B):
        (y1, u1, v1), _ = recon(*hwdevice.state_from_numpy(
            tuple(a[b] for a in args), dev))
        for got, want in ((yp[b], y1), (up[b], u1), (vp[b], v1)):
            if not np.array_equal(got, want.cpu().numpy()):
                raise AssertionError(f"sharded step: frame {b} differs "
                                     f"from the single-device recon")

    # REAL-BITSTREAM path: a tiny multi-GOP H.264 stream decoded
    # GOP-parallel across the devices (parallel/gop.py) must be
    # pixel-identical to the serial decoder
    pkts = gop_stream(dev)
    ngops = len(split_gops(pkts, "h264"))
    if ngops < 2:
        raise AssertionError(f"gop stream: {ngops} GOP")
    par = CodecParameters(codec_type=MediaType.VIDEO, codec_id="h264")
    serial = find_decoder("h264")(par, device=dev).open().decode_all(
        list(pkts))
    parallel = GOPParallelDecoder("h264", devices=devices).decode(
        list(pkts))
    if not len(serial) == len(parallel) == len(pkts):
        raise AssertionError(f"gop decode: {len(serial)} serial, "
                             f"{len(parallel)} parallel frames")
    for f1, f2 in zip(serial, parallel):
        for a, b in zip(f1.to_host().planes, f2.planes):
            if not np.array_equal(a, b):
                raise AssertionError("gop decode: a parallel frame differs "
                                     "from the serial decode")
    return {"devices": [str(d) for d in devices], "batch": B,
            "bits": want_bits, "gops": ngops, "frames": len(parallel)}
