"""Device ms a step under the render spans (preprocess, binning, window
gathers, post-processing, backward included), the blend kernels left out."""


def read(trace):
    ms = trace.device_s("raster", blend=False) * 1e3
    return ms / trace.steps if ms > 0 else None
