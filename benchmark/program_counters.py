"""The program's own counters of a traced run (`lara_tpu_torch/utils/trace.py`):
the tile binning's kept entries, slots and the entries its budget drops,
summed on the card while a profiler ran, which in a run of the benchmark is
its two traced phases. Nothing where the program has no such counters (a
program from before them) or where no operation ran on a device."""

from __future__ import annotations

from typing import Dict, Optional


def binning(trace) -> Optional[Dict[str, int]]:
    """{"entries", "slots", "overflow"} of the run whose Trace is `trace`."""
    if trace.busy_s <= 0:
        return None
    try:
        from lara_tpu_torch.utils.trace import counters
    except ImportError:
        return None
    got = counters()
    return got if got["slots"] > 0 else None
