"""Build and load the port's hand-written CUDA kernels.

Every source of `lara_tpu_torch/csrc/` is compiled at first use with nvcc
into a shared library with a plain C interface under
`build/lara_tpu_torch/` of the checkout, one nvcc process per source, all
started before any is waited for, each keyed by a hash of its source, the
shared headers and its flags, and bound with ctypes (no PyTorch headers, so
a build takes seconds). nvcc's output (ptxas's registers, spills and
warnings) is kept beside each library as `<stem>_<key>.log` and read back
on a cached build, so `build_log` always holds every kernel's lines.
A kernel that cannot be built raises: nothing falls back.

    libs = build_library()        # {"blend_fwd": CDLL, ..., "tile_windows": CDLL}
    build_other(csrc)             # the same from another checkout's sources
    other_log(csrc)               # and their nvcc logs
    kernel_resources(build_log)   # {"blend_fwd_kernel": {"registers": 64, ...}, ...}
    serialised_wgmma(build_log)   # kernels whose wgmma ptxas serialised
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "lara_tpu_torch"
_COMMON = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
           "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# --fmad=false on the blend: the values its decisions read (alpha against
# alpha_min, T (1 - alpha) against transmittance_min, the 3D/2D switch, the
# near cull) and the carries are written with explicit round-to-nearest
# intrinsics in csrc/blend_common.cuh, in the plain version's order; the
# flag keeps every other product and sum uncontracted too, so the stash and
# replay modes of the backward (two instantiations of one template) compute
# the same bits, and the kernels write fmaf() where contraction is wanted.
# The flash kernels keep FMA contraction: they make no threshold decisions.
_BLEND_FLAGS = _COMMON + ["--fmad=false"]

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
_BLEND_FWD_ARGS = [_P] * 6 + [_I] * 7 + [_F] * 6 + [_P]
_BLEND_BWD_ARGS = [_P] * 7 + [_I] * 8 + [_F] * 6 + [_P]
# name -> (source, nvcc flags, {C entry point: argtypes}); the `_sub` entry
# points run the tiles without an instantiation as sub-tiles
_KERNELS = {
    "blend_fwd": ("blend_fwd.cu", _BLEND_FLAGS,
                  {"lara_blend_fwd": _BLEND_FWD_ARGS,
                   "lara_blend_fwd_sub": _BLEND_FWD_ARGS + [_I, _P]}),
    "blend_bwd": ("blend_bwd.cu", _BLEND_FLAGS,
                  {"lara_blend_bwd": _BLEND_BWD_ARGS,
                   "lara_blend_bwd_global": _BLEND_BWD_ARGS + [_P],
                   "lara_blend_bwd_sub": _BLEND_BWD_ARGS + [_P, _I, _P, _P]}),
    "flash_fwd": ("flash_fwd.cu", _COMMON,
                  {"lara_flash_fwd": [_P] * 6 + [_I] * 5 + [_L] * 6 + [_F, _I, _P]}),
    "flash_bwd": ("flash_bwd.cu", _COMMON,
                  {"lara_flash_bwd": [_P] * 11 + [_I] * 5 + [_L] * 6 + [_F, _I, _P]}),
    "tile_windows": ("tile_windows.cu", _COMMON,
                     {"lara_tile_windows": [_P, _I, _P, _I, _I, _P, _P]}),
}
_libs: dict = {}
build_log = ""      # nvcc's output (registers, spills, warnings) of every library
# ptxas's codes for a wgmma it serialised: a wgmma on a
# branch it cannot prove warp-uniform, or a product in flight across a
# loop's back edge; the kernel then runs 27-34 % slower, and says so only here
_SERIALISED = re.compile(r"C75(14|15|19|20)|wgmma\S*.*serializ", re.IGNORECASE)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return str(path)


def library_path(name: str, csrc: Path = _CSRC) -> Path:
    """Where kernel library `name` of the sources in `csrc` is built: keyed
    by a hash of its source, the shared headers and its flags; its nvcc log
    has the suffix .log."""
    src, flags = _KERNELS[name][:2]
    headers = b"".join(h.read_bytes() for h in sorted(csrc.glob("*.cuh")))
    key = hashlib.sha256((csrc / src).read_bytes() + headers
                         + " ".join(flags).encode()).hexdigest()[:16]
    return _BUILD_DIR / f"{Path(src).stem}_{key}.so"


def build_library() -> dict:
    """Compile (once per source and flags hash) and load every kernel
    library. Returns {name: CDLL} with each entry point's argtypes set."""
    global build_log
    if _libs:
        return _libs
    libs, build_log = _build(_CSRC)
    _libs.update(libs)
    return _libs


def build_other(csrc: Path) -> dict:
    """The libraries of another checkout's kernel sources (its
    `lara_tpu_torch/csrc`, with the same C entry points), built as
    `build_library` builds the port's and returned without replacing them:
    for timing two versions of a kernel in one process. An entry point the
    other checkout lacks (one added since) is left out; the port's own
    libraries must have every one."""
    return _build(Path(csrc), strict=False)[0]


def other_log(csrc: Path) -> str:
    """The nvcc logs of the libraries `build_other(csrc)` built."""
    return "".join(library_path(name, Path(csrc)).with_suffix(".log").read_text()
                   for name in _KERNELS)


def _build(csrc: Path, strict: bool = True) -> tuple:
    paths, procs = {}, {}
    for name, (src, flags, _) in _KERNELS.items():
        paths[name] = library_path(name, csrc)
        if not (paths[name].exists() and paths[name].with_suffix(".log").exists()):
            _BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = paths[name].with_suffix(f".{os.getpid()}.tmp")
            procs[name] = (tmp, subprocess.Popen(
                [_nvcc(), *flags, "-o", str(tmp), str(csrc / src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = {name: proc.communicate()[0] for name, (_, proc) in procs.items()}
    for name, (tmp, proc) in procs.items():
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed to build {_KERNELS[name][0]}:\n{outs[name]}")
        tmp.with_suffix(".log").write_text(outs[name])
        os.replace(tmp.with_suffix(".log"), paths[name].with_suffix(".log"))
        os.replace(tmp, paths[name])
    log = "".join(paths[name].with_suffix(".log").read_text() for name in _KERNELS)
    libs = {}
    for name, (_, _, entries) in _KERNELS.items():
        lib = ctypes.CDLL(str(paths[name]))
        for sym, argtypes in entries.items():
            fn = getattr(lib, sym) if strict else getattr(lib, sym, None)
            if fn is not None:
                fn.argtypes, fn.restype = argtypes, ctypes.c_int
        libs[name] = lib
    return libs, log


def kernel_name(mangled: str) -> str:
    """`blend_bwd_kernel<16, 1, 0>` from the mangled name of a kernel in an
    anonymous namespace, as ptxas prints it (its integer and bool template
    arguments)."""
    m = re.match(r"_ZN(\d+)", mangled)
    if not m:
        return mangled
    rest = mangled[m.end() + int(m.group(1)):]
    m = re.match(r"(\d+)", rest)
    if not m:
        return mangled
    name = rest[m.end():m.end() + int(m.group(1))]
    t = re.match(r"I((?:L\w\d+E)+)E", rest[m.end() + int(m.group(1)):])
    if not t:
        return name
    args = re.findall(r"L\w(\d+)E", t.group(1))
    return f"{name}<{', '.join(args)}>"


def kernel_resources(log: str) -> dict:
    """{kernel: {"registers", "spill_stores", "spill_loads", "static_smem"}}
    from ptxas's `-v` lines in an nvcc log (bytes for the spills and the
    static shared memory, which a block holds beside its dynamic one)."""
    res, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = kernel_name(m.group(1))
            res[name] = {"registers": 0, "spill_stores": 0, "spill_loads": 0, "static_smem": 0}
            continue
        if name is None:
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m:
            res[name]["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            res[name]["static_smem"] = int(m.group(1)) if m else 0
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            res[name]["spill_stores"], res[name]["spill_loads"] = map(int, m.groups())
    return res


def serialised_wgmma(log: str) -> list:
    """Kernels of an nvcc log for which ptxas reports a serialised wgmma
    (codes C7514, C7515, C7519, C7520, or a line saying wgmma instructions
    are serialized): the function the line names, else the entry function
    being compiled."""
    found, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = kernel_name(m.group(1))
        elif _SERIALISED.search(line):
            m = re.search(r"function '(\S+?)'", line)
            kernel = kernel_name(m.group(1)) if m else (name or line.strip())
            if kernel not in found:
                found.append(kernel)
    return found


def blocks_per_sm(registers: int, smem: int, threads: int) -> int:
    """Resident blocks per SM of an H100 (sm_90) for a kernel of
    `registers` per thread, `smem` bytes of shared memory and `threads` per
    block: 64 warps, 32 blocks, 65,536 registers allocated 256 to a warp
    at a time, 233,472 bytes of shared memory with 1 KB reserved per block."""
    warps = -(-threads // 32)
    by_warps = 64 // warps
    regs_per_warp = -(-max(registers, 1) * 32 // 256) * 256
    by_regs = (65536 // regs_per_warp) // warps
    by_smem = 233472 // (smem + 1024)
    return min(32, by_warps, by_regs, by_smem)


def raise_on(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed (cudaError {err})")
