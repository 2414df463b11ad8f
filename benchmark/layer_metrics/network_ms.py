"""Device ms a step under the network's spans (ViT, ModLN, feature volume,
volume transformer, decoders, fine stage), backward and remat's
recomputation included."""


def read(trace):
    ms = trace.device_s("network") * 1e3
    return ms / trace.steps if ms > 0 else None
