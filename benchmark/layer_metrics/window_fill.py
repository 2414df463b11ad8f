"""How full the binning leaves the per-tile windows (%): the entries kept
under the tile budget over the windows' T·K slots, summed over the traced
phases' binnings (`benchmark/program_counters.py`). The window gather and
the blend read all T·K slots whatever the counts."""

from benchmark.program_counters import binning


def read(trace):
    c = binning(trace)
    return None if c is None else c["entries"] / c["slots"] * 100.0
