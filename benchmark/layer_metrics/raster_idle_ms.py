"""The device's idle ms a step while the host was in the rasterizer chain:
the span phase's idle gaps under `raster.*` spans as a share of all its
idle, times the untraced window's idle a step (its seconds a step less the
device-only profile's busy time a step), so that the profiler's host cost
cancels."""


def read(trace):
    total = sum(trace.gaps.values())
    if total <= 0 or trace.steps == 0 or trace.wall_step_s <= 0:
        return None
    raster = sum(s for name, s in trace.gaps.items() if name.startswith("raster."))
    return raster / total * (trace.wall_step_s - trace.busy_s / trace.steps) * 1e3
