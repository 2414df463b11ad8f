"""Device ms a micro-step under the losses' span, backward included."""


def read(trace):
    ms = trace.device_s("loss") * 1e3
    return ms / trace.steps if ms > 0 else None
