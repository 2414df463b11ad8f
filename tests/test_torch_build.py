"""The port's kernel build, on the CPU: the nvcc log kept beside each
library and read back on a cached build, the check for a wgmma that ptxas
serialised, and the blend kernels' shared memory and occupancy as their
wrapper states them."""

import pytest
import torch

from lara_tpu_torch.ops import _build
from lara_tpu_torch.ops.rasterizer import cuda_blend
from lara_tpu_torch.ops.rasterizer.types import RasterizeConfig

ENTRY = "_ZN12_GLOBAL__N_116flash_fwd_kernelILb1EEEvNS_6ParamsE"
CLEAN_LOG = f"""ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '{ENTRY}' for 'sm_90a'
ptxas info    : Function properties for {ENTRY}
    0 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 536 bytes cmem[0]
"""
SERIALISED_LOG = CLEAN_LOG + (
    f"ptxas info    : (C7515) Potential Performance Loss: wgmma.mma_async instructions are "
    f"serialized due to the presence of Extern calls in the function '{ENTRY}'.\n"
    "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_19dq_kernelEv' for 'sm_90a'\n"
    "ptxas info    : (C7520) Potential Performance Loss: wgmma.mma_async instructions are "
    "serialized due to non wgmma instructions defining accumulator registers of a wgmma "
    "between start and end of the pipeline stage.\n")


def test_serialised_wgmma_flags_ptxas_codes():
    """C7515 names its function; C7520 falls to the entry being compiled."""
    assert _build.serialised_wgmma(SERIALISED_LOG) == ["flash_fwd_kernel<1>", "dq_kernel"]
    assert _build.serialised_wgmma(CLEAN_LOG) == []


def test_kernel_resources_reads_registers_and_spills():
    assert _build.kernel_resources(CLEAN_LOG) == {
        "flash_fwd_kernel<1>": {"registers": 168, "spill_stores": 8, "spill_loads": 12,
                                "static_smem": 0}}
    fwd = CLEAN_LOG.replace("used 1 barriers,", "used 1 barriers, 32 bytes smem,")
    assert _build.kernel_resources(fwd)["flash_fwd_kernel<1>"]["static_smem"] == 32


def test_cached_build_returns_the_log_beside_the_library(monkeypatch, tmp_path):
    """A library found in the build directory is loaded without nvcc, and
    its log, written beside it, becomes `build_log`."""

    class FakeLib:
        def __init__(self, path):
            self._name = path

        def __getattr__(self, sym):
            fn = lambda *args: 0  # noqa: E731
            setattr(self, sym, fn)
            return fn

    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "_BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build.ctypes, "CDLL", FakeLib)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    for name in _build._KERNELS:
        so = _build.library_path(name)
        so.write_bytes(b"")
        so.with_suffix(".log").write_text(CLEAN_LOG.replace("flash_fwd", name))
    libs = _build.build_library()
    assert set(libs) == set(_build._KERNELS)
    for name in _build._KERNELS:
        assert CLEAN_LOG.replace("flash_fwd", name) in _build.build_log
    assert len(_build.kernel_resources(_build.build_log)) == len(_build._KERNELS)


def test_build_other_leaves_the_port_libraries(monkeypatch, tmp_path):
    """Another checkout's sources build into their own libraries (their own
    hash keys), returned without becoming the port's or its build log."""
    import shutil

    class FakeLib:
        def __init__(self, path):
            self._name = path

        def __getattr__(self, sym):
            fn = lambda *args: 0  # noqa: E731
            setattr(self, sym, fn)
            return fn

    other = tmp_path / "csrc"
    shutil.copytree(_build._CSRC, other)
    (other / "blend_bwd.cu").write_text("// another version\n")
    build = tmp_path / "build"
    build.mkdir()
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "build_log", "")
    monkeypatch.setattr(_build, "_BUILD_DIR", build)
    monkeypatch.setattr(_build.ctypes, "CDLL", FakeLib)
    for name in _build._KERNELS:
        so = _build.library_path(name, other)
        so.write_bytes(b"")
        so.with_suffix(".log").write_text(CLEAN_LOG)
    libs = _build.build_other(other)
    assert set(libs) == set(_build._KERNELS)
    assert libs["blend_bwd"]._name == str(_build.library_path("blend_bwd", other))
    assert _build.library_path("blend_bwd", other) != _build.library_path("blend_bwd")
    assert _build.library_path("blend_fwd", other) == _build.library_path("blend_fwd")
    assert _build._libs == {} and _build.build_log == ""


def test_missing_entry_point_fails_only_the_port_build(monkeypatch, tmp_path):
    """A library without one of its C entry points (a stale build) fails
    where the port loads it; another checkout's library may lack one added
    since, and is loaded without it."""

    class OldLib:
        def __init__(self, path):
            pass

        def __getattr__(self, sym):
            if sym == "lara_blend_bwd_global":
                raise AttributeError(sym)
            fn = lambda *args: 0  # noqa: E731
            setattr(self, sym, fn)
            return fn

    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "build_log", "")
    monkeypatch.setattr(_build, "_BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build.ctypes, "CDLL", OldLib)
    for name in _build._KERNELS:
        so = _build.library_path(name)
        so.write_bytes(b"")
        so.with_suffix(".log").write_text(CLEAN_LOG)
    with pytest.raises(AttributeError, match="lara_blend_bwd_global"):
        _build.build_library()
    libs = _build.build_other(_build._CSRC)
    assert "lara_blend_bwd_global" not in vars(libs["blend_bwd"])
    assert libs["blend_bwd"].lara_blend_bwd.restype is _build.ctypes.c_int


def test_library_without_log_is_rebuilt(monkeypatch, tmp_path):
    """A library whose log is missing counts as not built: without nvcc the
    build raises rather than load it with no log."""
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "_BUILD_DIR", tmp_path)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    for name in _build._KERNELS:
        _build.library_path(name).write_bytes(b"")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build_library()


def source_smem(tile, chunk, budget, replay, global_form):
    """`blend_bwd.cu:smem_bytes`, restated: the staged records (80 B per
    entry, at most 512 entries), the hit bits and end values of every
    32-entry sub-block of the kept chunks for the tile's pixels (4 B each;
    none in the global form), the per-warp partials [warps][group][19]
    (group: the chunk, at most 128 at tile 16 and 32 at tiles 8 and 32)."""
    pixels, nsub = tile * tile, -(-chunk // 32)
    kept = budget // chunk if replay else 1
    bits = 0 if global_form else 2 * kept * nsub * pixels
    group = min(chunk, 128 if tile == 16 else 32)
    return 80 * min(chunk, 512) + 4 * (bits + pixels // 64 * group * 19)


def chunks_and_budgets():
    """Every chunk up to 600, and the powers of two up to 4,096, each at
    budgets of 1 to 64 chunks, up to 8,192."""
    for chunk in sorted(set(range(1, 601)) | {2 ** i for i in range(13)}):
        for k in (1, 2, 3, 4, 8, 16, 32, 64):
            if chunk * k <= 8192:
                yield chunk, chunk * k


@pytest.mark.parametrize("tile", cuda_blend.TILES)
def test_blend_smem_fits_every_accepted_chunk(tile):
    """Every chunk and budget the kernels accept asks for at most one
    block's shared memory on sm_90 (232,448 bytes), in the form each
    backward takes there; the forward stages at most 512 entries at a time
    and needs no opt-in (48 KB)."""
    for chunk, budget in chunks_and_budgets():
        smem = cuda_blend.kernel_smem(chunk, budget, tile)
        assert 0 < smem["blend_bwd"] <= 232448, (chunk, budget)
        assert 0 < smem["blend_bwd_replay"] <= 232448, (chunk, budget)
        assert 0 < smem["blend_fwd"] <= 49152, (chunk, budget)


@pytest.mark.parametrize("tile", cuda_blend.TILES)
def test_replay_smem_grows_with_the_budget(tile):
    """`kernel_smem` states each kernel's shared memory as the sources
    compute it, for every tile, chunk and budget: the backward in its shared
    form where that fits 232,448 B, else in its global form; the replay's
    grows with the budget until it takes the global form."""
    for chunk, budget in chunks_and_budgets():
        smem = cuda_blend.kernel_smem(chunk, budget, tile)
        for kind, replay in (("blend_bwd", False), ("blend_bwd_replay", True)):
            shared = source_smem(tile, chunk, budget, replay, False)
            global_form = shared > 232448
            assert cuda_blend.bwd_global(tile, chunk, budget, replay) == global_form
            assert smem[kind] == source_smem(tile, chunk, budget, replay, global_form), \
                (kind, chunk, budget)
        assert smem["blend_fwd"] == max(80 * min(chunk, 512), cuda_blend.fwd_min_smem(tile))
    # tile 16 asks for what it asked before (PERF.md's table), tile 32's
    # replay at budget 1024 / chunk 64 and tile 16's at 4096 / 64 go global
    assert cuda_blend.kernel_smem(64, 128) == {"blend_fwd": 37904, "blend_bwd": 28672,
                                               "blend_bwd_replay": 32768}
    assert cuda_blend.kernel_smem(64, 512)["blend_bwd_replay"] == 57344
    assert source_smem(16, 64, 4096, True, False) == 286720
    assert cuda_blend.bwd_global(16, 64, 4096, True)
    assert cuda_blend.bwd_global(32, 64, 1024, True)
    assert not cuda_blend.bwd_global(32, 64, 512, True)
    assert not cuda_blend.bwd_global(16, 512, 512, False)
    assert cuda_blend.fwd_min_smem(16) == 233472 // 6 - 1024 + 16
    assert [_build.blocks_per_sm(80, cuda_blend.fwd_min_smem(t) + 4 * (t * t // 64 + 1),
                                 cuda_blend.threads(t)) for t in (8, 16)] == [20, 5]


class _Launched(Exception):
    """Raised in place of the kernel build: the wrapper got past its checks."""


def test_backward_refuses_a_chunk_past_its_limit(monkeypatch):
    """The chunk's limit is the budget, which it must divide, as in the
    JAX kernels: chunk 512 at budget 512 reaches the launch in both
    backward modes; a chunk twice the budget, or one that does not divide
    it, is refused before any launch."""
    def build_library():
        raise _Launched

    monkeypatch.setattr(_build, "build_library", build_library)

    def backward(budget, chunk, replay):
        cfg = RasterizeConfig(height=32, width=32, tile_budget=budget, pallas_chunk=chunk)
        entries = torch.zeros(cfg.num_tiles, budget, 13)
        counts = torch.zeros(cfg.num_tiles, dtype=torch.int32)
        cot = torch.zeros(cfg.num_tiles, 10, 256)
        if replay:
            return cuda_blend.blend_bwd_replay(entries, counts, torch.ones(2), cot, cfg)
        stash = torch.zeros(cfg.num_tiles, budget // chunk + 1, 4, 256)
        return cuda_blend.blend_bwd(entries, counts, torch.ones(2), stash,
                                    torch.zeros_like(counts), cot, cfg)

    for replay in (False, True):
        with pytest.raises(_Launched):
            backward(512, 512, replay)
        with pytest.raises(ValueError, match="pallas_chunk"):
            backward(256, 512, replay)
        with pytest.raises(ValueError, match="pallas_chunk"):
            backward(512, 96, replay)


@pytest.mark.parametrize("budget,chunk,tile,replay", [
    (4096, 64, 16, True),        # the replay refused before: 286,720 B, now global
    (1024, 64, 32, True),        # 345,088 B before, 306,176 B shared: global
    (512, 256, 16, False),       # backward chunks past 128
    (512, 512, 16, True),
    (2048, 1024, 16, False),     # the backward stages a chunk past 512 in pieces
    (32, 32, 8, True),
])
def test_refused_configs_reach_the_launch(monkeypatch, budget, chunk, tile, replay):
    """Configs the kernels refused before reach the build and launch."""
    def build_library():
        raise _Launched

    monkeypatch.setattr(_build, "build_library", build_library)
    cfg = RasterizeConfig(height=64, width=64, tile=tile, tile_budget=budget,
                          pallas_chunk=chunk)
    p = tile * tile
    entries = torch.zeros(cfg.num_tiles, budget, 13)
    counts = torch.zeros(cfg.num_tiles, dtype=torch.int32)
    with pytest.raises(_Launched):
        cuda_blend.blend_fwd(entries, counts, torch.ones(2), cfg, stash=not replay)
    with pytest.raises(_Launched):
        cuda_blend.blend_bwd_replay(entries, counts, torch.ones(2),
                                    torch.zeros(cfg.num_tiles, 10, p), cfg)
    form = cuda_blend.bwd_form(cfg, replay)
    assert form == ("global" if cuda_blend.bwd_global(tile, chunk, budget, replay) else "shared")
    if form == "global":
        kept = budget // chunk if replay else 1
        assert cuda_blend.scratch_words(cfg, replay) == (cfg.num_tiles * 2 * kept
                                                         * -(-chunk // 32) * p)


@pytest.mark.parametrize("tile", [4, 64])
def test_tile_without_instantiation_raises(monkeypatch, tile):
    """A tile other than 8, 16 or 32 no longer raises: each kernel's
    wrapper takes it to the launch, as sub-tiles of an instantiated edge
    (tile 4 as one 8×8 sub-tile with 16 of its pixels in the tile, tile 64
    as four of 32)."""
    def build_library():
        raise _Launched

    monkeypatch.setattr(_build, "build_library", build_library)
    cfg = RasterizeConfig(height=128, width=128, tile=tile, tile_budget=64, pallas_chunk=32)
    p = tile * tile
    entries = torch.zeros(cfg.num_tiles, 64, 13)
    counts = torch.zeros(cfg.num_tiles, dtype=torch.int32)
    cot = torch.zeros(cfg.num_tiles, 10, p)
    stash = torch.zeros(cfg.num_tiles, 3, 4, p)
    calls = [lambda: cuda_blend.blend_fwd(entries, counts, torch.ones(2), cfg),
             lambda: cuda_blend.blend_bwd(entries, counts, torch.ones(2), stash,
                                          torch.zeros_like(counts), cot, cfg),
             lambda: cuda_blend.blend_bwd_replay(entries, counts, torch.ones(2), cot, cfg)]
    for call in calls:
        with pytest.raises(_Launched):
            call()


def test_kernel_names_cover_every_instantiation():
    """Each instantiation's mangled name reads back as `cuda_blend.KERNELS`
    names it: the forward per tile and split, the backward per tile, mode,
    form and split, each one block a tile and sub-tiled."""
    for name in cuda_blend.KERNELS:
        base, args = name[:-1].split("<")
        parts = args.split(", ")
        code = "".join(f"L{'i' if i == 0 else 'b'}{a}E" for i, a in enumerate(parts))
        mangled = f"_ZN12_GLOBAL__N_1{len(base)}{base}I{code}EEvPKfNS_6ParamsE"
        assert _build.kernel_name(mangled) == name
    assert len(cuda_blend.KERNELS) == 2 * (3 * 2 + 3 * 8)
    # the split instantiations run where the chunk passes the staging or the
    # reduction group
    assert [cuda_blend.split_chunk("blend_fwd", 16, c) for c in (512, 1024)] == [False, True]
    assert [cuda_blend.split_chunk("blend_bwd", 16, c) for c in (128, 256)] == [False, True]
    assert [cuda_blend.split_chunk("blend_bwd_replay", 32, c) for c in (32, 64)] == [False, True]


@pytest.mark.parametrize("registers,smem,threads,want", [
    (64, 0, 256, 4),          # registers: 32 warps of 2,048
    (32, 0, 256, 8),          # warps: 64 per SM
    (40, 109568, 256, 2),     # shared memory
    (168, 0, 384, 1),
    (16, 0, 32, 32),          # blocks
])
def test_blocks_per_sm(registers, smem, threads, want):
    assert _build.blocks_per_sm(registers, smem, threads) == want
