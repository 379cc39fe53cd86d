"""`mpeg2.recon_graph_share` on a fake run: it reads the port's counters
`mpeg2.recon.graph` and `mpeg2.recon.eager` recorded after `install`, and
nothing from before it; None where no picture ran or the port has no
recorder. The two MPEG-2 cells list it."""

import pytest

from avbench import spec

SHARE = "mpeg2.recon_graph_share"
CELLS = ["mpeg2_mp_1080i.broadcast_fields", "mpeg2_mp_1080p.progressive_ipbb"]


class Run:
    def __init__(self):
        self.delivered = []


@pytest.fixture
def timer():
    from libav_tpu_torch.avutil import timer
    timer.disable()
    timer.reset()
    yield timer
    timer.disable()
    timer.reset()


def test_the_mpeg2_cells_list_it():
    per_layer = {m["name"]: m for m in spec.benchmark()["per_layer"]}
    m = per_layer[SHARE]
    assert m["workloads"] == CELLS
    assert (m["unit"], m["better"], m["moves"], m["source"]) == \
        ("%", "higher", "decode_fps", "program_counter")
    assert m["layer"] == per_layer["mpeg2.recon_ms"]["layer"]


@pytest.mark.parametrize("graph, eager, share", [
    (0, 0, None), (7, 0, 100.0), (0, 5, 0.0), (3, 1, 75.0)])
def test_recon_graph_share(timer, graph, eager, share):
    timer.count("mpeg2.recon.graph", 4)         # before the traced run
    timer.count("mpeg2.recon.eager", 2)
    run = Run()
    reader = spec.reader(SHARE)
    reader.install(run)
    timer.count("mpeg2.recon.capture")          # another counter: left out
    for _ in range(graph):
        timer.count("mpeg2.recon.graph")
    for _ in range(eager):
        timer.count("mpeg2.recon.eager")
    assert reader.read(run) == share


def test_a_port_without_the_recorder_reads_nothing(timer, monkeypatch):
    monkeypatch.delattr(timer, "enable")
    run = Run()
    reader = spec.reader(SHARE)
    reader.install(run)
    timer.count("mpeg2.recon.graph")
    assert reader.read(run) is None
