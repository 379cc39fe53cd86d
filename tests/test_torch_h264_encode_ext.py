"""The PyTorch port's H.264 encoder held against the JAX package's, packet
for packet, on the option set of each committed progressive
`testdata.H264_EXT` stream (explicit and implicit weighted prediction
with every partition shape, I_PCM; the interlaced ones are in
test_torch_h264_encode_field.py), at 64x64, through both encoders on the
CPU; exact equality. The committed streams are these option sets' 1080-line
encodes by the JAX encoder: chip_smoke.py re-encodes PAFF (and, where
its time allows, the others) on the card against them.
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
    n for n in testdata.H264_EXT if "1080p" in n))
def test_ext_packets_match_jax(name):
    _, _, n, settings = testdata.H264_EXT[name]
    settings = dict(settings)
    if settings.get("ipcm"):
        settings["ipcm"] = 5          # a few raw MBs in a 16-MB picture
    assert_packets_equal(port_encode(64, 64, n, settings),
                         jax_packets(64, 64, n, tuple(settings.items())))
