"""Share of MPEG-1/2 pictures whose recon program replayed from CUDA graphs,
percent: the port's counters `mpeg2.recon.graph` and `mpeg2.recon.eager`
(one per picture, by the way its recon program ran) over the traced run,
100 x graph / (graph + eager). None where no picture ran, or where the
port has no such counters. Moves `decode_fps`."""

from avbench import recorder


def install(run):
    recorder.install(run)


def read(run):
    graph = recorder.counter(run, "mpeg2.recon.graph")
    eager = recorder.counter(run, "mpeg2.recon.eager")
    if graph is None or eager is None or graph + eager <= 0:
        return None
    return 100.0 * graph / (graph + eager)
