"""H.264 recon programs on P and B pictures, ms per picture: a
synchronised span around `H264Decoder._reconstruct`. Moves
`decode_fps`."""

import importlib.util
import os

_spec = importlib.util.spec_from_file_location(
    "avbench.layers._recon", os.path.join(os.path.dirname(__file__),
                                          "_recon.py"))
_recon = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_recon)
I_TYPE = 1      # PictureType.I


def install(run):
    _recon.install(run)


def read(run):
    return _recon.mean_ms(run, lambda t: t != I_TYPE)
