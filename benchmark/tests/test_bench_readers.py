"""The per-layer readers on a hand-made trace: each found by its metric's
name or by the name before its first dot, each reading its layer's device
time, share or roofline, and each returning nothing where it finds
nothing to read."""

import pytest

from benchmark.flops import PEAK_BF16
from benchmark.run import metric_reader
from benchmark.trace import Trace
from benchmark.tests.tiny import REPO


def _trace():
    # 2 steps under each profile, 0.5 s a step untraced, 0.3 s busy a step
    tr = Trace(steps=2, window_s=1.2, wall_step_s=0.5, step_flops=0.1 * PEAK_BF16)
    tr.busy_s = 0.6
    tr.kernels = [("gemm", 40_000.0, "network.vit", 1), ("gemm_bwd", 20_000.0, "network", 2),
                  ("bmm", 30_000.0, "raster.render", 3),
                  ("blend_fwd_kernel", 8_000.0, "raster.blend", 4),
                  ("ssim", 6_000.0, "loss", 5), ("copy", 1_000.0, None, None),
                  ("net2", 4_000.0, "network2", 6)]
    tr.blend = [(0.001, 0.004), (0.002, 0.004)]
    return tr


@pytest.mark.parametrize("name,want", [
    ("network_ms.train", 30.0), ("network_ms.serve", 30.0), ("raster_ms.train", 15.0),
    ("loss_ms.train", 3.0), ("blend_roofline.serve", 37.5), ("idle_share.train", 40.0),
    ("mfu.train", 20.0), ("mfu.serve", 20.0)])
def test_reader_reads_its_layer(name, want):
    assert metric_reader(name, REPO)(_trace()) == pytest.approx(want)


@pytest.mark.parametrize("name", ["network_ms.serve", "raster_ms.train", "loss_ms.train",
                                  "blend_roofline.train", "idle_share.serve"])
def test_reader_finds_nothing(name):
    empty = Trace(steps=2, window_s=1.2, wall_step_s=0.5, step_flops=1.0)
    assert metric_reader(name, REPO)(empty) is None
