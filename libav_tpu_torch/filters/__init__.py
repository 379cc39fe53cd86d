"""Filter graphs (reference: libavfilter/ — SURVEY.md §2.6: push model,
filters implement filter_frame per input pad, frames propagate via
ff_filter_frame avfilter.c:643; graph parsing graphparser.c; format
negotiation formats.c with auto-inserted scale/resample converters).

The port's counterpart of `libav_tpu/filters`. A FilterGraph takes the
torch device it runs on (`FilterGraph(description, device="cpu")`;
"cuda" by default). Video filters compute as torch programs on the
device of the frame's planes, so a decoder's frames stay in the card's
memory through the chain; hwdownload brings them to the host, and the
filters after it run on the CPU. Audio filters run on the host sample
planes that the audio decoders hand out.
"""

from libav_tpu_torch.filters.graph import FilterGraph, Filter, register_filter  # noqa: F401
from libav_tpu_torch.filters import vf, af, src  # noqa: F401 (registration)
