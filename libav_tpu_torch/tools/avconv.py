"""avconv on the port (counterpart of `libav_tpu/tools/avconv.py`):

    python -m libav_tpu_torch.tools.avconv -i in.h264 -f framecrc out.crc

The option grammar, the transcode loop, the stream chains, pts correction
and the muxers are the JAX CLI's own code (`host_cli` loads it again as a
module of its own); what changes is what it imports:
  - `find_decoder` is the port's table on one torch device
    (`decoder_factory`): H.264 (kernel K1), MPEG-1/2 and MJPEG (kernel K2);
  - `find_encoder` gives only the host encoders, rawvideo and PCM, which
    pack bytes from `Frame.to_host()`; an encoder with a device part
    raises ENCODER_NOT_FOUND naming the ROADMAP.md step that ports it;
  - `-prof DIR` runs the port's timer: torch.profiler into DIR, plus the
    host timer report (with the H.264 decoder's `h264.entropy` span);
  - scaling and pixel-format conversion (swscale, `-s`, `-pix_fmt`) and
    filters (`-vf`, `-af`, `-filter_complex`) raise PATCHWELCOME naming
    their steps.
`libav_tpu.tools.avconv` itself is not touched. `python -m` decodes on
CUDA and exits nonzero with a message where there is none; `main(argv,
device="cpu")` runs the same path on the CPU.
"""

from __future__ import annotations

import functools
import sys

import torch

from libav_tpu.avutil.error import AVError, ENCODER_NOT_FOUND
from libav_tpu.codecs.api import find_encoder as _find_encoder
from libav_tpu.tools import avconv as _ref
from libav_tpu_torch import hostcode
from libav_tpu_torch.avutil import hwdevice, timer
from libav_tpu_torch.codecs import decoder_factory

# encoder id -> the ROADMAP.md module-queue step that ports its device part
ENCODER_STEPS = {
    "h264": "7", "mpeg1video": "8b", "mpeg2video": "8b", "mpeg4": "8b",
    "mjpeg": "9", "aac": "10", "ac3": "10", "mp1": "10", "mp2": "10",
    "mp3": "10", "flac": "10", "prores": "11", "ffv1": "15",
}

REFUSED = {
    "libav_tpu.swscale": "scaling and pixel-format conversion (-s, "
                         "-pix_fmt) are not ported to libav_tpu_torch yet "
                         "(ROADMAP.md module queue, step 10)",
    "libav_tpu.avresample": "audio resampling is not ported to "
                            "libav_tpu_torch yet (ROADMAP.md module queue, "
                            "step 10)",
    "libav_tpu.filters.graph": "filters (-vf, -af, -filter_complex) are "
                               "not ported to libav_tpu_torch yet "
                               "(ROADMAP.md module queue, step 12)",
}


def find_encoder(codec_id: str):
    """The JAX package's host encoders (rawvideo, pcm_*); any other
    raises ENCODER_NOT_FOUND naming its step."""
    if codec_id == "rawvideo" or codec_id.startswith("pcm_"):
        return _find_encoder(codec_id)
    step = ENCODER_STEPS.get(codec_id)
    raise AVError(ENCODER_NOT_FOUND, codec_id if step is None else
                  f"{codec_id}: its device part is not ported to "
                  f"libav_tpu_torch yet (ROADMAP.md module queue, step "
                  f"{step})")


@functools.lru_cache(maxsize=None)
def host_cli(device: torch.device):
    """libav_tpu.tools.avconv's code as a module of its own that decodes
    with the port on device."""
    return hostcode.load_host_module(
        _ref, f"{__name__}.on_{str(device).replace(':', '')}",
        replace={"libav_tpu.codecs": {"find_decoder": decoder_factory(device),
                                      "find_encoder": find_encoder},
                 "libav_tpu.avutil": {"timer": timer}},
        refuse=REFUSED)


def main(argv=None, device="cuda") -> int:
    try:
        dev = hwdevice.device(device)
    except RuntimeError as e:
        sys.stderr.write(f"avconv: {e}\n")
        return 1
    return host_cli(dev).main(argv)


if __name__ == "__main__":
    sys.exit(main())
