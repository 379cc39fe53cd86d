"""The import guard, in fresh interpreters."""

import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def python(code: str):
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("name, refused", [
    ("libav_tpu.avutil", True), ("libav_tpu", True), ("jax", True),
    ("jaxlib.xla_client", True), ("flax", True),
    ("libav_tpu_torch.avutil", False), ("json", False)])
def test_guard_by_whole_top_level_name(name, refused):
    r = python(f"""
from avbench import guard
guard.install()
try:
    import {name}
except ModuleNotFoundError as e:
    print('refused' if 'refused' in str(e) else 'missing')
else:
    print('imported')
""")
    assert r.returncode == 0, r.stderr
    assert (r.stdout.strip() == "refused") == refused, r.stdout


def test_loaded_compares_top_level_names():
    from avbench import guard
    mods = ["libav_tpu_torch.codecs", "libav_tpu.codecs", "jaxlib",
            "jax_like", "numpy"]
    assert guard.loaded(modules=mods) == ["jaxlib", "libav_tpu.codecs"]


def test_reference_imports_nothing_of_the_port():
    r = python("""
import sys
from avbench import guard
guard.install(guard.REFUSED + ('libav_tpu_torch',))
from avbench import reference
print(sorted({m.split('.')[0] for m in sys.modules}
             & {'jax', 'jaxlib', 'flax', 'libav_tpu', 'libav_tpu_torch'}))
""")
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"


def test_harness_loads_no_refused_module():
    r = python("""
import runpy, sys
from avbench import guard
guard.install()
from avbench import harness, control, trace, spec
for m in spec.benchmark()['per_layer']:
    spec.reader(m['name'])
spec.generator('chunked_loop')
import libav_tpu_torch.codecs
print(guard.loaded())
""")
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"


def test_run_without_a_card_fails_and_prints_no_result():
    r = subprocess.run([sys.executable, "avbench/run.py", "--workload",
                        "mpeg2_mp_1080i.broadcast_fields", "--seed",
                        "4294967301", "--seconds", "1", "--trace", "0"],
                       cwd=ROOT, capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert r.returncode != 0
    assert r.stdout.strip() == ""
