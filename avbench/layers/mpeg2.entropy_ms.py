"""MPEG-2 host slice entropy, ms per frame: a benchmark span around every
`MPEG2Decoder._decode_slice` (pure-Python VLC) over the traced run.
Moves `decode_fps`."""

TARGET = "libav_tpu_torch.codecs.mpeg12.dec:MPEG2Decoder._decode_slice"


def install(run):
    run.spans.patch("mpeg2.entropy", TARGET)
    run.mpeg2_entropy_frames0 = run.traced_frames


def read(run):
    frames = run.traced_frames - run.mpeg2_entropy_frames0
    seconds = run.spans.spans["mpeg2.entropy"].seconds()
    return 1e3 * seconds / frames if frames and seconds else None
