"""MPEG-2 recon of I and P frame pictures (the anchors), ms per anchor:
the port's `mpeg2.recon.anchor` span around `_reconstruct` of an I or P
picture in `MPEG1Decoder._finish_picture` (inside `mpeg2.recon`, tag
`type`), unsynchronised: the host's issue time. A chunk's first frame
leaves only after its I and first P picture. None where no anchor ran,
or where the port has no such span. Moves `first_frame_ms`."""

from avbench import recorder


def install(run):
    recorder.install(run)


def read(run):
    return recorder.mean_ms(run, "mpeg2.recon.anchor")
