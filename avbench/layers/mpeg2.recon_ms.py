"""MPEG-2 recon programs, ms per picture (a field picture counts as one):
synchronised spans around `MPEG2Decoder._reconstruct` and
`_reconstruct_field`. Moves `decode_fps`."""

DEC = "libav_tpu_torch.codecs.mpeg12.dec:MPEG2Decoder."


def install(run):
    run.spans.patch("mpeg2.recon", DEC + "_reconstruct", sync=True)
    run.spans.patch("mpeg2.recon_field", DEC + "_reconstruct_field",
                    sync=True)


def read(run):
    spans = [run.spans.spans[n] for n in ("mpeg2.recon", "mpeg2.recon_field")]
    n = sum(s.count() for s in spans)
    return 1e3 * sum(s.seconds() for s in spans) / n if n else None
