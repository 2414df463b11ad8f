"""The model FLOPs of a step over the untraced window's host seconds a
step, as a share of one H100's dense bf16 peak (%); `mfu.train` and
`mfu.serve` read it alike."""

from benchmark.flops import PEAK_BF16


def read(trace):
    if trace.wall_step_s <= 0:
        return None
    return trace.step_flops / trace.wall_step_s / PEAK_BF16 * 100.0
