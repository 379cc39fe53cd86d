"""Closed loop, one stream: the config's GOPs decoded again and again in
order, a fresh decoder per GOP (a chunk start), through the public
decode API on the run's device, every frame downloaded with
`Frame.to_host` as a raw or framecrc writer would.

Reports `rate` (frames per second over whole GOPs: the window closes
at the end of the GOP in flight when `--seconds` runs out) and
`first_frame_ms` (mean over every decoder opened in the window, from its
first packet sent to its first frame on the host)."""

from __future__ import annotations

from avbench import stats


def _decode_gop(run, kind):
    """-> (host planes per frame, seconds to the first frame)."""
    from libav_tpu_torch.avutil.error import AVError
    from libav_tpu_torch.avutil.frame import Packet
    from libav_tpu_torch.codecs import CodecParameters, find_decoder
    from libav_tpu_torch.codecs.api import MediaType
    par = CodecParameters(codec_type=MediaType.VIDEO, codec_id=run.codec)
    dec = find_decoder(run.codec)(par, device=run.device).open()
    frames, first = [], None
    t0 = run.now()

    def pump():
        nonlocal first
        while True:
            try:
                f = dec.receive_frame()
            except AVError:
                return
            frames.append(f.to_host().planes)
            if first is None:
                first = run.now() - t0
    try:
        for i, data in enumerate(run.gops[kind]):
            dec.send_packet(Packet(data=data, pts=i))
            pump()
        dec.send_packet(None)
        pump()
    finally:
        dec.close()
    return frames, first


def warm(run):
    for kind in range(len(run.gops)):
        _decode_gop(run, kind)
    run.sync()


def unit(run):
    """One more GOP, outside the window (a traced run's retake)."""
    kind = len(run.delivered) % len(run.gops)
    frames, _ = _decode_gop(run, kind)
    run.deliver(kind, frames)


def window(run):
    first = []
    start = run.start_window()
    k = 0
    while True:
        kind = k % len(run.gops)
        with run.unit():
            frames, first_s = _decode_gop(run, kind)
        run.end_unit(len(frames))
        run.deliver(kind, frames)
        if first_s is not None:
            first.append(first_s)
        k += 1
        if not run.window_open():
            break
    return {"rate": stats.whole_unit_rate(run.units, start),
            "first_frame_ms": stats.mean_ms(first)}
