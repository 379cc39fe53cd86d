"""Shared by the recon readers: a synchronised span around the H.264
decoder's `_reconstruct`, each record tagged with its picture type."""

TARGET = "libav_tpu_torch.codecs.h264.dec:H264Decoder._reconstruct"


def install(run):
    return run.spans.patch("h264.recon", TARGET, sync=True,
                           tag=lambda frame: int(frame.pict_type))


def mean_ms(run, keep):
    span = run.spans.spans["h264.recon"]
    n = span.count(keep)
    return 1e3 * span.seconds(keep) / n if n else None
