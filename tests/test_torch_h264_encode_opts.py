"""The PyTorch port's H.264 encoder held against the JAX package's, packet
for packet, on options past the bench settings and the defaults: I_4x4
with CABAC and deblock, and two references (CAVLC and CABAC); the
scaling matrices and poc types are in test_torch_h264_encode_poc.py.
Frames of the moving test pattern at 64x64 through both encoders on the
CPU; exact equality.
"""

import pytest
import torch

from test_torch_h264_encode import (assert_packets_equal, jax_packets,
                                    port_encode)


@pytest.fixture(autouse=True)
def _one_thread():
    # Tier-1 runs 6 xdist workers on 8 CPUs
    torch.set_num_threads(1)


@pytest.mark.parametrize("name,n,settings", [
    ("cabac i4x4 deblock", 4, {"entropy": "cabac", "i4x4": 1,
                               "deblock": 1, "qp": 32}),
    ("refs 2 cavlc", 5, {"refs": 2, "gop_size": 5, "qp": 30}),
    ("refs 2 cabac", 5, {"refs": 2, "entropy": "cabac", "qp": 26}),
])
def test_packets_match_jax(name, n, settings):
    assert_packets_equal(port_encode(64, 64, n, settings),
                         jax_packets(64, 64, n, tuple(settings.items())))
