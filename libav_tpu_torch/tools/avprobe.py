"""avprobe on the port (counterpart of `libav_tpu/tools/avprobe.py`):

    python -m libav_tpu_torch.tools.avprobe -show_frames in.m2v

The sections and their text are the JAX CLI's own code, loaded again as
a module of its own (`host_probe`) whose decoders are the port's on one
torch device: `-show_frames` decodes through them, and so does
`find_stream_info`'s trial decode (its JAX method imports the JAX codec
table inside its body, so it is rebound with an import that answers the
port's lookup).

Both places swallow every exception of a decoder (a codec without a
decoder, a corrupt packet). An AVError still is swallowed there; any
other exception of the port's decoders, a CUDA fault among them, is
carried past them as `DecoderFault` and raised again from `main`. The
device is resolved before anything is decoded.
"""

from __future__ import annotations

import functools
import sys

import torch

from libav_tpu.avutil.error import AVError
from libav_tpu.formats import api as formats_api
from libav_tpu.tools import avprobe as _ref
from libav_tpu_torch import hostcode
from libav_tpu_torch.avutil import hwdevice
from libav_tpu_torch.codecs import decoder_factory


class DecoderFault(BaseException):
    """A non-AVError exception of the port's decoder (its __cause__),
    past the host code's `except Exception`."""


def _escaping(fn):
    @functools.wraps(fn)
    def run(*args, **kw):
        try:
            return fn(*args, **kw)
        except AVError:
            raise
        except Exception as e:
            raise DecoderFault(e) from e
    return run


def probe_decoder_factory(device):
    """decoder_factory(device) whose decoders raise DecoderFault for any
    failure but an AVError."""
    find = decoder_factory(device)

    def lookup(codec_id: str):
        make = find(codec_id)

        def construct(*args, **kw):
            dec = _escaping(make)(*args, **kw)
            for name in ("open", "send_packet", "receive_frame", "_pump"):
                setattr(dec, name, _escaping(getattr(dec, name)))
            return dec
        return construct
    return lookup


def format_context(find):
    """A FormatContext stand-in whose open_input returns contexts whose
    find_stream_info trial-decodes with `find`."""
    parent = formats_api.FormatContext.find_stream_info
    names = dict(vars(formats_api), __builtins__=hostcode.host_builtins(
        replace={"libav_tpu.codecs.api": {"find_decoder": find}}))
    find_stream_info = hostcode.rebind(parent, names)

    class FormatContext:
        @staticmethod
        def open_input(url, format_name=None, options=None):
            ic = formats_api.FormatContext.open_input(url, format_name,
                                                      options)
            ic.find_stream_info = find_stream_info.__get__(ic)
            return ic
    return FormatContext


@functools.lru_cache(maxsize=None)
def host_probe(device: torch.device):
    """libav_tpu.tools.avprobe's code as a module of its own that decodes
    with the port on device."""
    find = probe_decoder_factory(device)
    return hostcode.load_host_module(
        _ref, f"{__name__}.on_{str(device).replace(':', '')}",
        replace={"libav_tpu.codecs": {"find_decoder": find},
                 "libav_tpu.formats": {"FormatContext":
                                       format_context(find)}})


def main(argv=None, device="cuda") -> int:
    try:
        dev = hwdevice.device(device)
    except RuntimeError as e:
        sys.stderr.write(f"avprobe: {e}\n")
        return 1
    try:
        return host_probe(dev).main(argv)
    except DecoderFault as fault:
        raise fault.__cause__ from None


if __name__ == "__main__":
    sys.exit(main())
