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


def test_blend_smem_fits_every_accepted_chunk():
    """Every chunk the backward accepts fits one block's shared memory on
    sm_90 (232,448 bytes); the forward needs no opt-in (48 KB) up to
    MAX_CHUNK."""
    for chunk in range(1, cuda_blend.MAX_BWD_CHUNK + 1):
        assert 0 < cuda_blend.kernel_smem(chunk)["blend_bwd"] <= 232448, chunk
    for chunk in range(1, cuda_blend.MAX_CHUNK + 1):
        assert 0 < cuda_blend.kernel_smem(chunk)["blend_fwd"] <= 49152, chunk


def test_replay_smem_grows_with_the_budget():
    """`kernel_smem` states the replay backward's shared memory as
    `blend_bwd.cu:smem_bytes` computes it: the staged records (80 B per
    entry), the hit bits and end values of every sub-block of 32 entries of
    every chunk of the budget for 256 pixels (4 B each), and the per-warp
    partials [4][chunk][19]; the stash mode keeps one chunk's bits. Every
    budget the wrapper accepts for the replay fits a block's 232,448 B."""
    def source_formula(budget, chunk, replay):
        kept = budget // chunk if replay else 1
        return 80 * chunk + 4 * (2 * kept * -(-chunk // 32) * 256 + 4 * chunk * 19)

    assert cuda_blend.kernel_smem(64, 128)["blend_bwd"] == 28672
    assert cuda_blend.kernel_smem(64, 128)["blend_bwd_replay"] == 32768
    assert cuda_blend.kernel_smem(64, 512)["blend_bwd_replay"] == 57344
    for chunk in range(1, cuda_blend.MAX_BWD_CHUNK + 1):
        for budget in range(chunk, 64 * chunk + 1, chunk):
            smem = cuda_blend.kernel_smem(chunk, budget)
            assert smem["blend_bwd_replay"] == source_formula(budget, chunk, True)
            assert smem["blend_bwd"] == source_formula(budget, chunk, False)
            accepted = smem["blend_bwd_replay"] <= cuda_blend.MAX_SMEM
            if budget // chunk <= 16:      # every count of chunks the replay took before
                assert accepted, (budget, chunk)
    assert cuda_blend.MAX_SMEM == 232448


def test_backward_refuses_a_chunk_past_its_limit():
    chunk = 2 * cuda_blend.MAX_BWD_CHUNK
    cfg = RasterizeConfig(height=32, width=32, tile_budget=chunk, pallas_chunk=chunk)
    entries = torch.zeros(cfg.num_tiles, chunk, 13)
    counts = torch.zeros(cfg.num_tiles, dtype=torch.int32)
    with pytest.raises(ValueError, match="pallas_chunk"):
        cuda_blend.blend_bwd_replay(entries, counts, torch.ones(2),
                                    torch.zeros(cfg.num_tiles, 10, 256), cfg)


@pytest.mark.parametrize("registers,smem,threads,want", [
    (64, 0, 256, 4),          # registers: 32 warps of 2,048
    (32, 0, 256, 8),          # warps: 64 per SM
    (40, 109568, 256, 2),     # shared memory
    (168, 0, 384, 1),
    (16, 0, 32, 32),          # blocks
])
def test_blocks_per_sm(registers, smem, threads, want):
    assert _build.blocks_per_sm(registers, smem, threads) == want
