"""The PyTorch port's H.264 encoder held against the JAX package's, packet
for packet, on the default scaling matrices (High profile, with I_8x8)
and pic_order_cnt types 0, 1 and 2. Frames of the moving test pattern at
64x64 through both encoders on the CPU; exact equality.
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
    ("scmatrix", 4, {"scmatrix": "default", "entropy": "cabac",
                     "i8x8": 1}),
    ("poc 0", 4, {"poc": 0, "qp": 24}),
    ("poc 1", 4, {"poc": 1, "qp": 24}),
    ("poc 2", 4, {"poc": 2, "qp": 24}),
])
def test_packets_match_jax(name, n, settings):
    assert_packets_equal(port_encode(64, 64, n, settings),
                         jax_packets(64, 64, n, tuple(settings.items())))
