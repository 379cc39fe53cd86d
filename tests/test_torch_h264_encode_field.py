"""The PyTorch port's H.264 encoder held against the JAX package's, packet
for packet, on the option sets of the committed interlaced
`testdata.H264_EXT` streams: PAFF field pictures (the bottom field
predicting from the top one, the cross-parity chroma offset, field
deblock) and all-field MBAFF, at 64x64 (both need a height that is a
multiple of 32), through both encoders on the CPU; exact equality.
"""

import pytest
import torch

from libav_tpu_torch import testdata
from test_torch_h264_encode import (assert_packets_equal, jax_packets,
                                    port_encode)


@pytest.fixture(autouse=True)
def _one_thread():
    # Tier-1 runs 6 xdist workers on 8 CPUs
    torch.set_num_threads(1)


@pytest.mark.parametrize("name", sorted(
    n for n in testdata.H264_EXT if "1088i" in n))
def test_field_packets_match_jax(name):
    _, _, n, settings = testdata.H264_EXT[name]
    assert_packets_equal(port_encode(64, 64, n, settings),
                         jax_packets(64, 64, n, tuple(settings.items())))
