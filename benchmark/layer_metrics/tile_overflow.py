"""The share of the binning's tile entries that the tile budget drops (%):
Σ max(raw count − K, 0) over Σ raw count, summed over the traced phases'
binnings (`benchmark/program_counters.py`). A smaller budget raises the
cell's rate and this share together: it is what the budget costs."""

from benchmark.program_counters import binning


def read(trace):
    c = binning(trace)
    if c is None or c["entries"] + c["overflow"] == 0:
        return None
    return c["overflow"] / (c["entries"] + c["overflow"]) * 100.0
