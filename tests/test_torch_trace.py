"""The port's spans and counters (`lara_tpu_torch/utils/trace.py`) on the CPU:

  (a) without a profiler a span is the one shared null context, and a
      render adds nothing to the counters;
  (b) under `torch.profiler` a tiny fine forward and a tiny training
      micro-step open every name of `trace.SPANS`, the rasterizer chain's
      stages inside `raster.render` / `raster.rerender`, and the counters
      count each first render's binning once;
  (c) the counters equal the sums of the raw per-tile counts worked out by
      hand, with tiles past the budget, in both bin modes;
  (d) outputs and gradients are the same bits with a profiler and without.
"""

import contextlib

import numpy as np
import pytest
import torch

from lara_tpu_torch.config import Config, ModelConfig, RenderConfig, TrainConfig
from lara_tpu_torch.models import LaRaNet
from lara_tpu_torch.ops.rasterizer import tiled
from lara_tpu_torch.ops.rasterizer.preprocess import preprocess_surfels
from lara_tpu_torch.ops.rasterizer.types import RasterizeConfig
from lara_tpu_torch.ops.renderer import render_view
from lara_tpu_torch.tools.timing import activated, bench_camera
from lara_tpu_torch.tools.workload import lara_workload
from lara_tpu_torch.train.loss import compute_losses
from lara_tpu_torch.train.state import TrainState
from lara_tpu_torch.train.step import make_forward, make_train_step
from lara_tpu_torch.utils import trace
from lara_tpu_torch.utils.camera import build_rays_np, fov_to_ixt
from tests.test_torch_blend import one_torch_thread  # noqa: F401

SIZE, FOV = 64, 0.8
STAGES = ("raster.preprocess", "raster.bin", "raster.gather", "raster.post")


def tiny_config() -> Config:
    """The tiny network of the CPU tests (tests/test_model.py:tiny_config)."""
    return Config(
        n_views=2,
        model=ModelConfig(
            encoder_dim=48, encoder_depth=2, encoder_heads=4, patch_size=16,
            n_groups=(4,), K=2, sh_degree=1, num_layers=2, num_heads=4,
            view_embed_dim=8, embedding_dim=64, vol_feat_reso=8,
            vol_embedding_reso=8, vol_embedding_out_dim=32,
            n_offset_groups=16, fine_budget=512),
        render=RenderConfig(tile=16, dup=3, tile_budget=64, eval_tile_budget=64,
                            pallas_chunk=32, visible_budget=0, eval_visible_budget=0),
        train=TrainConfig(warmup_iters=1, grad_accum=1))


def tiny_batch() -> dict:
    """One scene of 4 orbit views at SIZE² in the reference schema (the
    first 2 are inputs)."""
    rng = np.random.default_rng(0)
    n = 4
    ixts = np.tile(fov_to_ixt(np.array([FOV, FOV]), np.array([SIZE, SIZE]))[None], (n, 1, 1))
    c2ws = []
    for i in range(n):
        a = 2 * np.pi * i / n
        eye = np.array([2.0 * np.sin(a), 0.3, -2.0 * np.cos(a)])
        z = -eye / np.linalg.norm(eye)
        x = np.cross(np.array([0.0, -1.0, 0.0]), z)
        x /= np.linalg.norm(x)
        c2w = np.eye(4)
        c2w[:3, :3] = np.stack([x, np.cross(z, x), z], axis=1)
        c2w[:3, 3] = eye
        c2ws.append(c2w)
    c2ws = np.stack(c2ws).astype(np.float32)
    row = {"tar_rgb": rng.uniform(size=(n, SIZE, SIZE, 3)), "tar_c2w": c2ws,
           "tar_w2c": np.linalg.inv(c2ws), "tar_ixt": ixts,
           "tar_rays": build_rays_np(c2ws, ixts, SIZE, SIZE),
           "tar_rays_down": build_rays_np(c2ws, ixts, SIZE, SIZE, 1.0 / 16),
           "near_far": np.array([1.2, 2.8]), "fovx": np.array(FOV),
           "fovy": np.array(FOV), "bg_color": np.ones((n, 3))}
    return {k: torch.from_numpy(np.asarray(v, np.float32)[None]) for k, v in row.items()}


@pytest.fixture(scope="module")
def tiny():
    cfg = tiny_config()
    net = LaRaNet(cfg, dtype=torch.float32, device="cpu",
                  generator=torch.Generator().manual_seed(0))
    return cfg, net, tiny_batch()


def _profiled(fn):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return prof.events()


def _render_args(n: int = 4096, seed: int = 0):
    scene = lara_workload(n=n, seed=seed, device="cpu")
    return (*activated(scene), bench_camera("cpu"))


def test_span_without_profiler_is_the_shared_null_context():
    assert not torch.autograd._profiler_enabled()
    a, b = trace.span("raster.render"), trace.span("network")
    assert a is b and isinstance(a, contextlib.nullcontext)
    trace.reset()
    means, shs, op, sc, rot, cam = _render_args()
    cfg = RasterizeConfig(height=SIZE, width=SIZE, tile_budget=16, pallas_chunk=16)
    render_view(cam, None, means, shs, op, sc, rot, torch.ones(3), cfg)
    assert trace.counters() == {"entries": 0, "slots": 0, "overflow": 0}


def test_profiled_forward_and_micro_step_open_every_span(tiny):
    cfg, net, batch = tiny
    state = TrainState(net, cfg.train, max_iters=10)
    step = make_train_step(net, state, True)
    fwd = make_forward(net, with_fine=True)
    trace.reset()
    events = _profiled(lambda: (fwd(batch), step(batch)))
    names = {e.name for e in events}
    assert set(trace.SPANS) <= names, sorted(set(trace.SPANS) - names)
    assert not {"step", "raster.blend"} & names
    for e in events:
        if e.name in STAGES:
            parents, x = [], e.cpu_parent
            while x is not None:
                parents.append(x.name)
                x = x.cpu_parent
            assert {"raster.render", "raster.rerender"} & set(parents), (e.name, parents)
    # one binning per first render: 2·n_views of the request and of the step
    renders = sum(e.name == "raster.render" for e in events)
    assert renders == 2 * (2 * cfg.n_views)
    rcfg = net._render_cfg(SIZE, SIZE, train=False)
    got = trace.counters()
    assert got["slots"] == renders * rcfg.num_tiles * rcfg.tile_budget
    assert 0 < got["entries"] <= got["slots"]
    net.eval()


def _hand_counts(g, cfg: RasterizeConfig):
    """Raw per-tile counts: every kept slot of the nearest visible surfels."""
    depth_key = torch.where(g.valid, g.depth, torch.inf)
    n = g.depth.shape[0]
    v = min(cfg.visible_budget, n) if cfg.visible_budget else n
    order_v = torch.argsort(depth_key, stable=True)[:v]
    tile_id, _ = tiled._slot_tiles(tiled._pack_tile_bounds(g, cfg)[order_v], cfg)
    return torch.bincount(tile_id.flatten().long(), minlength=cfg.num_tiles + 1)[:-1]


# a tile holds at most `visible` surfels: budget >= visible drops nothing
@pytest.mark.parametrize("bin_mode,budget,visible", [
    ("sort", 16, 0), ("count", 16, 0), ("count", 64, 3000), ("sort", 256, 256),
    ("count", 64, 64)])
def test_counters_match_hand_sums(bin_mode, budget, visible):
    means, shs, op, sc, rot, cam = _render_args(seed=budget)
    cfg = RasterizeConfig(height=SIZE, width=SIZE, tile_budget=budget, pallas_chunk=16,
                          visible_budget=visible, bin_mode=bin_mode)
    g = preprocess_surfels(means, shs, op, sc, rot, cam, cfg)
    raw = _hand_counts(g, cfg)
    trace.reset()
    _profiled(lambda: tiled.bin_view(g, cfg))
    _, binned = tiled.bin_view(g, cfg)
    clamped = torch.clamp(raw, max=budget)
    assert torch.equal(binned.counts.long(), clamped)
    overflow = int((raw - clamped).sum())
    assert (overflow > 0) == (budget < visible or not visible)
    assert trace.counters() == {"entries": int(clamped.sum()),
                                "slots": cfg.num_tiles * budget, "overflow": overflow}


def test_outputs_and_gradients_bitwise_equal_under_profiler(tiny):
    cfg, net, batch = tiny
    net.train()

    def run():
        net.zero_grad(set_to_none=True)
        out = net(batch, with_fine=True, train=True)
        loss, _ = compute_losses(batch, out, 2002)
        loss.backward()
        return ({k: v.detach().clone() for k, v in out.items()},
                {n: p.grad.clone() for n, p in net.named_parameters() if p.grad is not None})

    plain = run()
    profiled = []
    _profiled(lambda: profiled.append(run()))
    for a, b in zip(plain, profiled[0]):
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), k
    net.zero_grad(set_to_none=True)
    net.eval()


@pytest.mark.parametrize("stash", [True, False])
def test_inference_blend_runs_under_the_autograd_op(monkeypatch, stash):
    """Without a gradient the blend's forward launch runs inside
    `_BlendFunction`'s op, which the profiler links its kernel to (a ctypes
    launch under a bare span is linked to no op), and writes no stash."""
    from lara_tpu_torch.ops.rasterizer import cuda_blend
    calls = []

    def blend_fwd(entries, counts, scalars, cfg, stash=False):
        calls.append(stash)
        return torch.zeros(cfg.num_tiles, cuda_blend.NUM_CHANNELS, cfg.tile ** 2)

    monkeypatch.setattr(cuda_blend, "blend_fwd", blend_fwd)
    cfg = RasterizeConfig(height=32, width=32, tile_budget=32, pallas_chunk=32,
                          stash_carries=stash)
    args = (torch.zeros(cfg.num_tiles, 32, 13), torch.zeros(cfg.num_tiles, dtype=torch.int32),
            torch.ones(2), cfg, False)
    with torch.no_grad():
        events = _profiled(lambda: cuda_blend._BlendFunction.apply(*args))
    assert calls == [False]
    op = cuda_blend._BlendFunction.__name__
    assert op not in trace.SPANS
    zeros = [e for e in events if e.name == "aten::zeros"]
    assert zeros and all(e.cpu_parent is not None and e.cpu_parent.name == op for e in zeros)
