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

The backward: autograd of the plain version against `jax.vjp` of
`blend_tiles_pallas` with `pallas_stash_carries=True` (its replay-free
backward kernel, interpret mode) and with `pallas_stash_carries=False`
(its replay backward kernel, `_run_bwd`), with a random cotangent on all
10 channels, at the gradient bar of tests/test_pallas.py: atol 5e-4, rtol
1e-3. The median's cotangent is ignored by both (its gradient is 0). On
the card, the replay backward kernel is held to the stash path bit for bit,
as tests/test_pallas.py holds the JAX kernels.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lara_tpu.ops.rasterizer import RasterizeConfig as JaxRasterizeConfig
from lara_tpu.ops.rasterizer.preprocess import preprocess_surfels as jax_preprocess
from lara_tpu.ops.rasterizer.tiled import bin_view as jax_bin_view
from lara_tpu.ops.rasterizer.tiled import window_gather as jax_window_gather
from lara_tpu_torch.ops import _build
from lara_tpu_torch.ops.rasterizer import cuda_blend
from lara_tpu_torch.ops.rasterizer.types import RasterizeConfig
from tests.test_rasterizer import front_camera

ATOL = {0: 2e-4, 1: 2e-4, 2: 2e-4, 3: 2e-4, 4: 1e-3, 6: 2e-4, 7: 2e-4, 8: 2e-4, 9: 2e-4}
MEDIAN_ATOL, MEDIAN_MAX_FLIPS = 1e-3, 1e-3


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The suite runs several pytest workers on the CPU at once; torch's
    intra-op thread pool in each of them would oversubscribe the cores, and
    these small ops then run many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
    """The port's RasterizeConfig with the same values as a JAX one (the
    JAX package's binned backends "tiled" and "pallas" are the port's
    "cuda")."""
    fields = {f.name for f in dataclasses.fields(RasterizeConfig)} - {"backend"}
    return RasterizeConfig(stash_carries=cfg.pallas_stash_carries,
                           backend="reference" if cfg.backend == "reference" else "cuda",
                           **{k: v for k, v in dataclasses.asdict(cfg).items() if k in fields})


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
    before = dict(cuda_blend.LAUNCHES)
    cuda_blend.blend_tiles(entries.requires_grad_(True), counts, scalars, cfg)
    assert cuda_blend.LAUNCHES == before


def test_failed_build_raises(monkeypatch, tmp_path):
    """Without nvcc the build raises; nothing falls back."""
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "_BUILD_DIR", tmp_path)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build_library()


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
    before = cuda_blend.LAUNCHES["blend_fwd"]
    got = cuda_blend.blend_tiles(*args, tcfg)
    torch.cuda.synchronize()
    assert cuda_blend.LAUNCHES["blend_fwd"] == before + 1
    want = cuda_blend.blend_tiles_reference(*args, tcfg)
    assert_accumulators_close(got.cpu().numpy(), want.cpu().numpy())


@pytest.mark.cuda
def test_backward_kernel_matches_reference_on_cuda():
    """The stash forward + backward kernels against autograd of the plain
    version on the card (the gradient bar); skipped without a GPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    cfg = jax_cfg(tile_budget=128, pallas_chunk=64, dup=3)
    entries, counts, scalars = make_windows(scene_np(5, 400), cfg)
    tcfg = torch_cfg(cfg)
    cot = torch.from_numpy(cotangent(entries.shape[0], 3)).cuda()
    grads = []
    for fn in (cuda_blend.blend_tiles, cuda_blend.blend_tiles_reference):
        e, c, sc = (torch.from_numpy(a).cuda() for a in (entries, counts, scalars))
        e.requires_grad_(True)
        (g,) = torch.autograd.grad(fn(e, c, sc, tcfg), e, cot)
        grads.append(g.cpu().numpy())
    np.testing.assert_allclose(grads[0], grads[1], atol=5e-4, rtol=1e-3)


def cotangent(num_tiles, seed, pixels=256):
    """A random cotangent of the accumulators [T, 10, P], numpy-made."""
    rng = np.random.default_rng(seed)
    return rng.normal(size=(num_tiles, 10, pixels)).astype(np.float32)


def grads_both(pb, entries, counts, scalars, cfg, cot):
    """(port's plain autograd gradient, jax.vjp of the Pallas blend)."""
    _, vjp = jax.vjp(lambda e: pb.blend_tiles_pallas(
        e, jnp.asarray(counts), jnp.asarray(scalars), cfg), jnp.asarray(entries))
    (want,) = vjp(jnp.asarray(cot))
    e = torch.from_numpy(entries).requires_grad_(True)
    out = cuda_blend.blend_tiles(e, torch.from_numpy(counts), torch.from_numpy(scalars),
                                 torch_cfg(cfg))
    (got,) = torch.autograd.grad(out, e, torch.from_numpy(cot))
    return got.numpy(), np.asarray(want)


def backward_case(case):
    if case == "opaque":
        cfg = jax_cfg(tile_budget=64, pallas_chunk=32)
        return cfg, make_windows(opaque_stack_np(), cfg)
    cfg = jax_cfg(tile_budget=64, pallas_chunk=32, dup=3)
    entries, counts, scalars = make_windows(scene_np(9, 400), cfg)
    counts = counts.copy()
    counts[::3] = 0
    counts[1::3] += 1000
    return cfg, (entries, counts, scalars)


@pytest.mark.parametrize("budget,chunk", [(64, 32), (64, 64), (128, 32), (128, 64)])
def test_reference_backward_matches_pallas_random_scene(pallas_interpret, budget, chunk):
    cfg = jax_cfg(tile_budget=budget, pallas_chunk=chunk, dup=3)
    assert cfg.pallas_stash_carries
    entries, counts, scalars = make_windows(scene_np(5, 800), cfg)
    got, want = grads_both(pallas_interpret, entries, counts, scalars, cfg,
                           cotangent(cfg.num_tiles, budget + chunk))
    assert np.abs(want).max() > 1.0
    np.testing.assert_allclose(got, want, atol=5e-4, rtol=1e-3)


@pytest.mark.parametrize("case", ["opaque", "empty_and_over_budget"])
def test_reference_backward_matches_pallas_edge_cases(pallas_interpret, case):
    cfg, (entries, counts, scalars) = backward_case(case)
    got, want = grads_both(pallas_interpret, entries, counts, scalars, cfg,
                           cotangent(cfg.num_tiles, 1))
    np.testing.assert_allclose(got, want, atol=5e-4, rtol=1e-3)
    rows = np.arange(cfg.tile_budget)[None, :] < np.minimum(counts, cfg.tile_budget)[:, None]
    assert np.all(got[~rows] == 0.0)
    assert np.abs(got[rows]).max() > 0.0


@pytest.mark.parametrize("budget,chunk", [(64, 32), (64, 64), (128, 32), (128, 64)])
def test_reference_backward_matches_pallas_replay(pallas_interpret, budget, chunk):
    """Against the replay backward kernel (`pallas_stash_carries=False`)."""
    cfg = jax_cfg(tile_budget=budget, pallas_chunk=chunk, dup=3, pallas_stash_carries=False)
    entries, counts, scalars = make_windows(scene_np(5, 800), cfg)
    got, want = grads_both(pallas_interpret, entries, counts, scalars, cfg,
                           cotangent(cfg.num_tiles, budget + chunk))
    assert np.abs(want).max() > 1.0
    np.testing.assert_allclose(got, want, atol=5e-4, rtol=1e-3)


@pytest.mark.parametrize("case", ["opaque", "empty_and_over_budget"])
def test_reference_backward_matches_pallas_replay_edge_cases(pallas_interpret, case):
    cfg, (entries, counts, scalars) = backward_case(case)
    cfg = dataclasses.replace(cfg, pallas_stash_carries=False)
    got, want = grads_both(pallas_interpret, entries, counts, scalars, cfg,
                           cotangent(cfg.num_tiles, 1))
    np.testing.assert_allclose(got, want, atol=5e-4, rtol=1e-3)
    rows = np.arange(cfg.tile_budget)[None, :] < np.minimum(counts, cfg.tile_budget)[:, None]
    assert np.all(got[~rows] == 0.0)


def test_replay_backward_matches_pallas_past_16_chunks(pallas_interpret):
    """The replay backward at 32 chunks per tile (budget 128, chunk 4): the
    JAX kernel keeps a [max_chunks, 4, P] scratch for any chunk count, and
    the port's has no chunk-count limit either."""
    cfg = jax_cfg(tile_budget=128, pallas_chunk=4, dup=3, pallas_stash_carries=False)
    entries, counts, scalars = make_windows(scene_np(5, 800), cfg)
    assert counts.max() > 16 * cfg.pallas_chunk
    got, want = grads_both(pallas_interpret, entries, counts, scalars, cfg,
                           cotangent(cfg.num_tiles, 132))
    assert np.abs(want).max() > 1.0
    np.testing.assert_allclose(got, want, atol=5e-4, rtol=1e-3)


@pytest.fixture(scope="module")
def tile_windows():
    """{tile: windows of the random scene at 64², budget 64, chunk 32},
    made once per tile: the forward and both backward cases share them."""
    cache = {}

    def get(tile):
        if tile not in cache:
            cache[tile] = make_windows(scene_np(5, 800), jax_cfg(tile=tile, pallas_chunk=32,
                                                                  dup=3))
        return cache[tile]

    return get


@pytest.mark.parametrize("tile", [8, 32])
def test_reference_matches_pallas_other_tiles(pallas_interpret, tile_windows, tile):
    """The forward at 8×8 and 32×32 tiles (64² at budget 64, chunk 32):
    tile² pixels per tile, the dup clamp at (dup − 1)·tile/2."""
    cfg = jax_cfg(tile=tile, tile_budget=64, pallas_chunk=32, dup=3)
    entries, counts, scalars = tile_windows(tile)
    assert entries.shape[0] == (64 // tile) ** 2 and counts.max() == 64
    got, want = run_both(pallas_interpret, entries, counts, scalars, cfg)
    assert got.shape[2] == tile * tile and want[:, 3].max() > 0.5
    assert_accumulators_close(got, want)


@pytest.mark.parametrize("stash", [True, False], ids=["stash", "replay"])
@pytest.mark.parametrize("tile", [8, 32])
def test_reference_backward_matches_pallas_other_tiles(pallas_interpret, tile_windows, tile,
                                                      stash):
    """The backward at 8×8 and 32×32 tiles against the JAX kernel from the
    stash (`_run_bwd_stash`) and replaying (`_run_bwd`)."""
    cfg = jax_cfg(tile=tile, tile_budget=64, pallas_chunk=32, dup=3,
                  pallas_stash_carries=stash)
    entries, counts, scalars = tile_windows(tile)
    got, want = grads_both(pallas_interpret, entries, counts, scalars, cfg,
                           cotangent(cfg.num_tiles, tile, tile * tile))
    assert np.abs(want).max() > 1.0
    np.testing.assert_allclose(got, want, atol=5e-4, rtol=1e-3)


class _Launched(Exception):
    """Raised in place of the kernel build: the wrapper got past its checks."""


def test_replay_knob_reaches_the_wrapper(monkeypatch):
    """RasterizeConfig.stash_carries picks the backward kernel; the replay
    is refused neither by its count of chunks nor by its shared memory:
    where the hit bits of every chunk would pass what a block may ask for,
    it takes its global form and still reaches the launch."""
    cfg = jax_cfg(tile_budget=64, pallas_chunk=32, pallas_stash_carries=False)
    assert torch_cfg(cfg).stash_carries is False
    assert torch_cfg(jax_cfg()).stash_carries is True

    def build_library():
        raise _Launched

    monkeypatch.setattr(_build, "build_library", build_library)

    def replay(budget, chunk):
        big = RasterizeConfig(height=32, width=32, tile_budget=budget, pallas_chunk=chunk)
        cuda_blend.blend_bwd_replay(torch.zeros(big.num_tiles, budget, 13),
                                    torch.zeros(big.num_tiles, dtype=torch.int32),
                                    torch.ones(2), torch.zeros(big.num_tiles, 10, 256), big)

    assert cuda_blend.bwd_global(16, 64, 4096, True)
    with pytest.raises(_Launched):     # 286,720 B of shared memory: refused before
        replay(4096, 64)
    with pytest.raises(_Launched):     # 32 chunks: past the replay's old 16-chunk limit
        replay(1024, 32)


@pytest.mark.cuda
def test_replay_backward_matches_stash_on_cuda():
    """The replay backward kernel against the stash forward + backward on
    the card: carries, processed-chunk counts and gradients bit for bit;
    skipped without a GPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    cfg = jax_cfg(tile_budget=128, pallas_chunk=32, dup=3)
    entries, counts, scalars = make_windows(scene_np(5, 400), cfg)
    tcfg = torch_cfg(cfg)
    e, c, sc = (torch.from_numpy(a).cuda() for a in (entries, counts, scalars))
    cot = torch.from_numpy(cotangent(entries.shape[0], 3)).cuda()
    _, carries, ndone = cuda_blend.blend_fwd(e, c, sc, tcfg, stash=True)
    grad = cuda_blend.blend_bwd(e, c, sc, carries, ndone, cot, tcfg)
    grad_r, carries_r, ndone_r = cuda_blend.blend_bwd_replay(e, c, sc, cot, tcfg,
                                                             return_carries=True)
    assert torch.equal(ndone_r, ndone) and torch.equal(grad_r, grad)
    used = (torch.arange(carries.shape[1], device="cuda")[None, :] <= ndone[:, None])
    assert torch.equal(carries_r[used], carries[used])


@pytest.mark.cuda
def test_replay_backward_matches_stash_past_16_chunks_on_cuda():
    """The replay backward at 32 chunks per tile (budget 128, chunk 4)
    against the stash path on the card: processed-chunk counts, carries and
    gradients bit for bit; skipped without a GPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    cfg = jax_cfg(tile_budget=128, pallas_chunk=4, dup=3)
    entries, counts, scalars = make_windows(scene_np(5, 800), cfg)
    assert counts.max() > 16 * cfg.pallas_chunk
    tcfg = torch_cfg(cfg)
    e, c, sc = (torch.from_numpy(a).cuda() for a in (entries, counts, scalars))
    cot = torch.from_numpy(cotangent(entries.shape[0], 3)).cuda()
    _, carries, ndone = cuda_blend.blend_fwd(e, c, sc, tcfg, stash=True)
    grad = cuda_blend.blend_bwd(e, c, sc, carries, ndone, cot, tcfg)
    grad_r, carries_r, ndone_r = cuda_blend.blend_bwd_replay(e, c, sc, cot, tcfg,
                                                             return_carries=True)
    assert int(ndone.max()) > 16
    assert torch.equal(ndone_r, ndone) and torch.equal(grad_r, grad)
    used = (torch.arange(carries.shape[1], device="cuda")[None, :] <= ndone[:, None])
    assert torch.equal(carries_r[used], carries[used])


def test_reference_median_has_no_gradient():
    """A cotangent on the median channel alone gives a zero gradient (the
    TPU kernel defines it so, pallas_blend.py:487-490)."""
    cfg = jax_cfg(tile_budget=64, pallas_chunk=32, dup=3)
    entries, counts, scalars = make_windows(scene_np(5, 800), cfg)
    e = torch.from_numpy(entries).requires_grad_(True)
    out = cuda_blend.blend_tiles(e, torch.from_numpy(counts), torch.from_numpy(scalars),
                                 torch_cfg(cfg))
    assert out[:, 5].abs().max() > 0.5
    cot = torch.zeros_like(out)
    cot[:, 5] = 1.0
    (g,) = torch.autograd.grad(out, e, cot)
    assert torch.count_nonzero(g) == 0


def test_reference_stash_matches_pallas(pallas_interpret):
    """What the plain version reports as the stash forward's outputs
    (carry-ins of the processed chunks, processed-chunk counts) against
    `_run_fwd(stash=True)`."""
    cfg, (entries, counts, scalars) = backward_case("empty_and_over_budget")
    acc, carries = pallas_interpret._run_fwd(
        jnp.asarray(entries), jnp.asarray(counts), jnp.asarray(scalars), cfg, stash=True)
    ndone = np.asarray(acc[:, 10, 0]).astype(np.int32)
    _, got, got_ndone = cuda_blend.blend_tiles_reference(
        torch.from_numpy(entries), torch.from_numpy(counts), torch.from_numpy(scalars),
        torch_cfg(cfg), return_stash=True)
    np.testing.assert_array_equal(got_ndone.numpy(), ndone)
    assert ndone.max() == 2 and ndone.min() == 0
    carries = np.asarray(carries)
    for t_ in range(cfg.num_tiles):
        np.testing.assert_allclose(got.numpy()[t_, :ndone[t_]], carries[t_, :ndone[t_]],
                                   atol=2e-4)


def cuda_case(case):
    """Windows of one test case on the card: the random scene, opaque
    surfels, and counts past the budget with empty tiles."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    if case == "random":
        cfg = jax_cfg(tile_budget=128, pallas_chunk=32, dup=3)
        arrays = make_windows(scene_np(5, 400), cfg)
    else:
        cfg, arrays = backward_case(case)
    e, c, sc = (torch.from_numpy(a).cuda() for a in arrays)
    cot = torch.from_numpy(cotangent(e.shape[0], 3)).cuda()
    return torch_cfg(cfg), e, c, sc, cot


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["random", "opaque", "empty_and_over_budget"])
def test_forward_with_and_without_stash_agree_on_cuda(case):
    """The stash forward's accumulators are the forward's, bit for bit."""
    tcfg, e, c, sc, _ = cuda_case(case)
    out_s, _, _ = cuda_blend.blend_fwd(e, c, sc, tcfg, stash=True)
    assert torch.equal(out_s, cuda_blend.blend_fwd(e, c, sc, tcfg))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["random", "opaque", "empty_and_over_budget"])
def test_backward_is_deterministic_on_cuda(case):
    """Two backward calls on the same inputs give the same bits (the block
    reduction has a fixed order and no atomics)."""
    tcfg, e, c, sc, cot = cuda_case(case)
    _, carries, ndone = cuda_blend.blend_fwd(e, c, sc, tcfg, stash=True)
    first = cuda_blend.blend_bwd(e, c, sc, carries, ndone, cot, tcfg)
    assert torch.equal(first, cuda_blend.blend_bwd(e, c, sc, carries, ndone, cot, tcfg))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["opaque", "empty_and_over_budget"])
def test_replay_backward_matches_stash_edge_cases_on_cuda(case):
    """The replay backward against the stash path on opaque tiles (early
    exit) and on empty and over-budget tiles: processed-chunk counts,
    carries and gradients bit for bit."""
    tcfg, e, c, sc, cot = cuda_case(case)
    _, carries, ndone = cuda_blend.blend_fwd(e, c, sc, tcfg, stash=True)
    grad = cuda_blend.blend_bwd(e, c, sc, carries, ndone, cot, tcfg)
    grad_r, carries_r, ndone_r = cuda_blend.blend_bwd_replay(e, c, sc, cot, tcfg,
                                                             return_carries=True)
    assert torch.equal(ndone_r, ndone) and torch.equal(grad_r, grad)
    used = (torch.arange(carries.shape[1], device="cuda")[None, :] <= ndone[:, None])
    assert torch.equal(carries_r[used], carries[used])
