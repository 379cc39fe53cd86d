"""The PyTorch port's H.264 encoder through the CLI and back through the
port's decoder, against the JAX package: `avconv -c:v h264` with the
bench options (the CLI run of chip_smoke.py's phase 18) on the 64x64
bench stream gives the JAX CLI's bytes, and the port's H264Decoder on the
CPU decodes the port encoder's own packets (bench settings and the
defaults) to the JAX decoder's frames. Exact equality.
"""

import hashlib

import numpy as np
import pytest
import torch

from libav_tpu.tools import avconv as jax_avconv
from libav_tpu_torch import testdata
from libav_tpu_torch.avutil.frame import Packet
from libav_tpu_torch.codecs.h264 import H264Decoder
from libav_tpu_torch.tools import avconv
from test_torch_h264_encode import port_encode
from tools.gen_torch_smoke_stream import decode_reference


@pytest.fixture(autouse=True)
def _one_thread():
    # Tier-1 runs 6 xdist workers on 8 CPUs
    torch.set_num_threads(1)


def test_avconv_h264_matches_jax(tmp_path):
    """`avconv -c:v h264` with the bench options (the CLI run of the smoke
    run's phase 18, on the 64x64 bench stream): the same bytes."""
    src = testdata.SMALL_H264
    args = list(testdata.ENCODE_CLI["out.h264"][1])
    out = {}
    for name, tool, kw in (("jax", jax_avconv, {}),
                           ("port", avconv, {"device": "cpu"})):
        out[name] = tmp_path / f"{name}.h264"
        assert tool.main(["-i", src, *args, str(out[name])], **kw) == 0
    want = out["jax"].read_bytes()
    assert out["port"].read_bytes() == want
    assert hashlib.md5(want).hexdigest() != hashlib.md5(
        open(src, "rb").read()).hexdigest()


@pytest.mark.parametrize("settings", [testdata.BENCH_SETTINGS, {}])
def test_port_decodes_its_own_packets(settings):
    datas = port_encode(64, 64, 5, settings)
    dec = H264Decoder(device="cpu")
    try:
        got = [f.to_host().planes for f in dec.decode_all(
            Packet(data=d, pts=i) for i, d in enumerate(datas))]
    finally:
        dec.close()
    want = decode_reference(datas)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        for gp, wp in zip(g, w):
            np.testing.assert_array_equal(gp, wp)
