"""The port's blend against the JAX package's Pallas blend.

`blend_tiles` on CPU tensors runs the plain PyTorch version
(`blend_tiles_reference`); it is held against
`lara_tpu.ops.rasterizer.pallas_blend.blend_tiles_pallas` in Pallas
interpret mode on the same [T, K, 13] windows, made with the JAX package's
preprocess + binning from one projected random scene.

Tolerances (those of tests/test_pallas.py): atol 2e-4 on rgb, alpha,
normal and distortion; 1e-3 on the depth sum and the median depth. The
median may flip on a pixel whose transmittance sits at 0.5, so it is
compared on all but at most 0.1% of the pixels.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lara_tpu.ops.rasterizer import RasterizeConfig as JaxRasterizeConfig
from lara_tpu.ops.rasterizer.preprocess import preprocess_surfels as jax_preprocess
from lara_tpu.ops.rasterizer.tiled import bin_view as jax_bin_view
from lara_tpu.ops.rasterizer.tiled import window_gather as jax_window_gather
from lara_tpu_torch.ops.rasterizer import cuda_blend
from lara_tpu_torch.ops.rasterizer.types import RasterizeConfig
from tests.test_rasterizer import front_camera

ATOL = {0: 2e-4, 1: 2e-4, 2: 2e-4, 3: 2e-4, 4: 1e-3, 6: 2e-4, 7: 2e-4, 8: 2e-4, 9: 2e-4}
MEDIAN_ATOL, MEDIAN_MAX_FLIPS = 1e-3, 1e-3


@pytest.fixture
def pallas_interpret(monkeypatch):
    """Run the Pallas kernels in interpret mode (as tests/test_pallas.py)."""
    import lara_tpu.ops.rasterizer.pallas_blend as pb

    orig = pb.pl.pallas_call

    def patched(*args, **kw):
        kw["interpret"] = True
        return orig(*args, **kw)

    monkeypatch.setattr(pb.pl, "pallas_call", patched)
    return pb


def scene_np(seed, n, extent=0.35, scale_rng=(-4.5, -3.2), op_rng=(-1.0, 3.0)):
    """A random surfel scene with the ranges of tests/test_rasterizer.py
    random_scene, drawn with numpy: (means, shs, opacities, scales, quats)."""
    rng = np.random.default_rng(seed)
    means = rng.uniform(-extent, extent, (n, 3))
    shs = rng.normal(size=(n, 4, 3)) * 0.3
    shs[:, 0, :] += 1.0
    op = 1.0 / (1.0 + np.exp(-rng.uniform(*op_rng, n)))
    scales = np.exp(rng.uniform(*scale_rng, (n, 2)))
    quats = rng.normal(size=(n, 4))
    return tuple(a.astype(np.float32) for a in (means, shs, op, scales, quats))


def opaque_stack_np(n=48):
    """Opaque surfels stacked along the optical axis: most tiles exit early."""
    means = np.stack([np.zeros(n), np.zeros(n), np.linspace(-0.3, 0.3, n)], -1)
    shs = np.zeros((n, 4, 3))
    shs[:, 0, :] = (np.array([0.9, 0.4, 0.1]) - 0.5) / 0.28209479177387814
    op = np.full((n,), 0.97)
    scales = np.full((n, 2), 0.06)
    quats = np.tile([[1.0, 0.0, 0.0, 0.0]], (n, 1))
    return tuple(a.astype(np.float32) for a in (means, shs, op, scales, quats))


def jax_cfg(**kw):
    base = dict(height=64, width=64, tile=16, dup=2, tile_budget=64,
                sh_degree=1, backend="pallas", pallas_chunk=32)
    base.update(kw)
    return JaxRasterizeConfig(**base)


def torch_cfg(cfg):
    """The port's RasterizeConfig with the same values as a JAX one."""
    fields = {f.name for f in dataclasses.fields(RasterizeConfig)}
    return RasterizeConfig(**{k: v for k, v in dataclasses.asdict(cfg).items()
                              if k in fields})


def make_windows(scene, cfg):
    """[T, K, 13] entries, counts and scalars from the JAX pipeline."""
    cam = front_camera()
    g = jax_preprocess(*(jnp.asarray(a) for a in scene), cam, cfg)
    packed, binned = jax_bin_view(g, cfg)
    entries = jax_window_gather(packed, binned.win_gidx, binned.entry_valid,
                                cfg.dup * cfg.dup)
    scalars = jnp.stack([cam.tanfovx, cam.tanfovy]).astype(jnp.float32)
    return tuple(np.array(a) for a in (entries, binned.counts, scalars))


def assert_accumulators_close(got, want):
    """got/want [T, 10, P] raw accumulators, tolerances of the module doc."""
    for c, atol in ATOL.items():
        np.testing.assert_allclose(got[:, c], want[:, c], atol=atol, err_msg=f"channel {c}")
    bad = np.abs(got[:, 5] - want[:, 5]) > MEDIAN_ATOL
    assert bad.mean() <= MEDIAN_MAX_FLIPS, f"median differs on {bad.sum()} pixels"


def run_both(pb, entries, counts, scalars, cfg):
    want = np.asarray(pb.blend_tiles_pallas(
        jnp.asarray(entries), jnp.asarray(counts), jnp.asarray(scalars), cfg))
    got = cuda_blend.blend_tiles(torch.from_numpy(entries), torch.from_numpy(counts),
                                 torch.from_numpy(scalars), torch_cfg(cfg))
    assert got.shape == want.shape
    return got.numpy(), want


@pytest.mark.parametrize("budget,chunk", [(64, 32), (64, 64), (128, 32), (128, 64)])
def test_reference_matches_pallas_random_scene(pallas_interpret, budget, chunk):
    cfg = jax_cfg(tile_budget=budget, pallas_chunk=chunk, dup=3)
    entries, counts, scalars = make_windows(scene_np(5, 800), cfg)
    # the scene must exercise partial chunks and full windows
    assert np.any(counts % chunk) and counts.max() == budget
    got, want = run_both(pallas_interpret, entries, counts, scalars, cfg)
    assert want[:, 3].max() > 0.5
    assert_accumulators_close(got, want)


def test_reference_matches_pallas_opaque_early_exit(pallas_interpret):
    cfg = jax_cfg(tile_budget=64, pallas_chunk=32)
    entries, counts, scalars = make_windows(opaque_stack_np(), cfg)
    got, want = run_both(pallas_interpret, entries, counts, scalars, cfg)
    assert want[:, 3].max() > 0.99     # saturated pixels: the exit is taken
    assert_accumulators_close(got, want)


def test_reference_matches_pallas_empty_and_over_budget(pallas_interpret):
    cfg = jax_cfg(tile_budget=64, pallas_chunk=32, dup=3)
    entries, counts, scalars = make_windows(scene_np(9, 400), cfg)
    counts = counts.copy()
    counts[::3] = 0                    # empty tiles
    counts[1::3] += 1000               # counts past the budget: clamped to K
    got, want = run_both(pallas_interpret, entries, counts, scalars, cfg)
    assert np.all(got[::3] == 0.0)
    assert_accumulators_close(got, want)


def test_blend_tiles_rejects_bad_inputs():
    cfg = RasterizeConfig(height=32, width=32, tile_budget=64, pallas_chunk=32)
    entries = torch.zeros(cfg.num_tiles, 64, 13)
    counts = torch.zeros(cfg.num_tiles, dtype=torch.int32)
    scalars = torch.ones(2)
    with pytest.raises(ValueError, match="counts"):
        cuda_blend.blend_tiles(entries, counts.long(), scalars, cfg)
    with pytest.raises(ValueError, match="entries"):
        cuda_blend.blend_tiles(entries.double(), counts, scalars, cfg)
    with pytest.raises(ValueError, match="pallas_chunk"):
        cuda_blend.blend_tiles(entries, counts, scalars,
                               dataclasses.replace(cfg, pallas_chunk=48))
    with pytest.raises(ValueError, match="cuda or cpu"):
        cuda_blend.blend_tiles(entries.to("meta"), counts.to("meta"),
                               scalars.to("meta"), cfg)
    # the CPU path never counts as a kernel launch
    before = cuda_blend.blend_tiles.launches
    cuda_blend.blend_tiles(entries, counts, scalars, cfg)
    assert cuda_blend.blend_tiles.launches == before


def test_failed_build_raises(monkeypatch, tmp_path):
    """Without nvcc the build raises; nothing falls back."""
    monkeypatch.setattr(cuda_blend, "_lib", None)
    monkeypatch.setattr(cuda_blend, "_BUILD_DIR", tmp_path)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc"):
        cuda_blend.build_library()


@pytest.mark.cuda
def test_kernel_matches_reference_on_cuda():
    """The CUDA kernel against the plain version on the card (the same
    tolerances); skipped without a GPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    cfg = jax_cfg(tile_budget=128, pallas_chunk=64, dup=3)
    entries, counts, scalars = make_windows(scene_np(5, 400), cfg)
    tcfg = torch_cfg(cfg)
    args = [torch.from_numpy(a).cuda() for a in (entries, counts, scalars)]
    before = cuda_blend.blend_tiles.launches
    got = cuda_blend.blend_tiles(*args, tcfg)
    torch.cuda.synchronize()
    assert cuda_blend.blend_tiles.launches == before + 1
    want = cuda_blend.blend_tiles_reference(*args, tcfg)
    assert_accumulators_close(got.cpu().numpy(), want.cpu().numpy())
