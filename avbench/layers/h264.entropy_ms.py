"""H.264 host entropy, ms per access unit: the port's own `h264.entropy`
timer span (`codecs/h264/dec.py` `_entropy_nals`, read by
`host_entropy_stats`) over the traced run. Moves `decode_fps`."""


def install(run):
    from libav_tpu_torch.codecs.h264 import dec
    run.h264_entropy0 = dec.host_entropy_stats()


def read(run):
    from libav_tpu_torch.codecs.h264 import dec
    n0, s0 = run.h264_entropy0
    n1, s1 = dec.host_entropy_stats()
    return 1e3 * (s1 - s0) / (n1 - n0) if n1 > n0 else None
