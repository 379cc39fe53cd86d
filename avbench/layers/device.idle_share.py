"""Device idle share, percent of the traced window: torch.profiler over
each unit of the window, busy = the union of every device interval,
units whose profile lost hand-kernel launches left out (`avbench/
trace.py`). Moves `decode_fps`."""

from avbench import stats


def install(run):
    pass


def read(run):
    t = run.trace
    if t is None or not t.kept:
        return None
    return stats.idle_share(t.busy_s, t.window_s)
