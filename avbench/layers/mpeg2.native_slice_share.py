"""Share of MPEG-1/2 slices whose entropy decode ran native, percent: the
port's counters `mpeg2.slice.native` and `mpeg2.slice.python` (one per
slice, by the engine that ran it) over the traced run, 100 x native /
(native + python). None where no slice ran, or where the port has no such
counters. Moves `decode_fps`."""

from avbench import recorder


def install(run):
    recorder.install(run)


def read(run):
    native = recorder.counter(run, "mpeg2.slice.native")
    python = recorder.counter(run, "mpeg2.slice.python")
    if native is None or python is None or native + python <= 0:
        return None
    return 100.0 * native / (native + python)
