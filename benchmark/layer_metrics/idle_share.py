"""The share of a step in which no operation runs on the device (%): one
less the device's busy time a step, from the device-only profile, over the
untraced window's host seconds a step, so that the profiler's host cost
does not count as idle time."""


def read(trace):
    if trace.wall_step_s <= 0 or trace.steps == 0 or trace.busy_s <= 0:
        return None
    return (1.0 - trace.busy_s / trace.steps / trace.wall_step_s) * 100.0
