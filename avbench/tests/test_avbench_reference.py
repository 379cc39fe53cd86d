"""The reference md5s against the JAX package's golden digests, and the
comparison on frames the tests alter."""

import json
import os

import numpy as np

from avbench import reference, spec

ROOT = spec.ROOT


def test_config_md5s_are_the_golden_of_each_stream():
    # the configuration's frame md5s are the JAX decoder's goldens in the
    # port's testdata, frame for frame
    bench = spec.benchmark()
    golden = {"h264_high_1080p": "h264_1080p_ipbb_cabac.golden.json",
              "mpeg2_mp_1080i": "mpeg2_1080i_fieldpic.golden.json"}
    for name, fn in golden.items():
        with open(os.path.join(ROOT, "libav_tpu_torch", "testdata", fn)) as f:
            want = [fr["md5"] for fr in json.load(f)["frames"]]
        got = [m for s in spec.config(bench, name)["streams"]
               for m in s["frame_md5"]]
        assert got == want, name


def test_md5_is_of_the_planes_in_order():
    y = np.arange(16, dtype=np.uint8).reshape(4, 4)
    u = np.full((2, 2), 7, np.uint8)
    v = np.full((2, 2), 9, np.uint8)
    import hashlib
    assert reference.md5([y, u, v]) == hashlib.md5(
        y.tobytes() + u.tobytes() + v.tobytes()).hexdigest()
    assert reference.md5([y, v, u]) != reference.md5([y, u, v])


def frames(n, base=0):
    return [[np.full((4, 4), base + i, np.uint8), np.zeros((2, 2), np.uint8),
             np.zeros((2, 2), np.uint8)] for i in range(n)]


def test_compare_counts_every_number():
    want = [[reference.md5(f) for f in frames(3)]]
    n = reference.compare(want, [(0, frames(3)), (0, frames(3))])
    assert reference.passed(n) and n["frames"] == 6
    off = frames(3)
    off[1][2][1, 1] = 3
    n = reference.compare(want, [(0, off), (0, frames(3)[:2])])
    assert (n["frames_missing"], n["frames_off"], n["frames_extra"],
            n["frames"]) == (1, 1, 0, 5)
    assert not reference.passed(n)
    n = reference.compare(want, [(0, frames(4))])
    assert n["frames_extra"] == 1 and not reference.passed(n)
    # frames in the wrong order: every displaced frame is off
    n = reference.compare(want, [(0, frames(3)[::-1])])
    assert n["frames_off"] == 2 and not reference.passed(n)
    assert not reference.passed(reference.compare(want, []))
