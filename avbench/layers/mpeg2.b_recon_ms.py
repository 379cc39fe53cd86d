"""MPEG-2 recon of B frame pictures, ms per B picture: the port's
`mpeg2.recon.b` span around `_reconstruct` of a B picture in
`MPEG1Decoder._finish_picture` (inside `mpeg2.recon`), unsynchronised, so
the host's time to issue the picture's forward and backward MC, their
average, K2 and the add. None where no B picture ran, or where the port
has no such span. Moves `decode_fps`."""

from avbench import recorder


def install(run):
    recorder.install(run)


def read(run):
    return recorder.mean_ms(run, "mpeg2.recon.b")
