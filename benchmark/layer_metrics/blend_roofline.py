"""The blend kernels' share of their bound over the kept blend calls of the
span phase (%): Σ bound / Σ device time, the bound of a call from its
inputs (`benchmark/trace.py:blend_bound_s`)."""


def read(trace):
    if not trace.blend:
        return None
    return sum(b for b, _ in trace.blend) / sum(s for _, s in trace.blend) * 100.0
