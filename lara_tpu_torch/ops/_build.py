"""Build and load the port's hand-written CUDA kernels.

Every source of `lara_tpu_torch/csrc/` is compiled at first use with nvcc
into a shared library with a plain C interface under
`build/lara_tpu_torch/` of the checkout, one nvcc process per source, all
started before any is waited for, each keyed by a hash of its source, the
shared headers and its flags, and bound with ctypes (no PyTorch headers, so
a build takes seconds).
A kernel that cannot be built raises: nothing falls back.

    libs = build_library()        # {"blend_fwd": CDLL, ..., "tile_windows": CDLL}
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "lara_tpu_torch"
_COMMON = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
           "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# --fmad=false on the blend: every product and sum rounds on its own, as in
# the plain version's elementwise ops, so alpha is computed bit for bit alike
# and the alpha >= alpha_min cull takes the same decisions in both; the
# backward's forward walks repeat the forward kernel's decisions exactly.
# The flash kernels keep FMA contraction: they make no threshold decisions.
_BLEND_FLAGS = _COMMON + ["--fmad=false"]

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
# name -> (source, nvcc flags, C entry point, argtypes)
_KERNELS = {
    "blend_fwd": ("blend_fwd.cu", _BLEND_FLAGS, "lara_blend_fwd",
                  [_P] * 6 + [_I] * 7 + [_F] * 6 + [_P]),
    "blend_bwd": ("blend_bwd.cu", _BLEND_FLAGS, "lara_blend_bwd",
                  [_P] * 7 + [_I] * 8 + [_F] * 6 + [_P]),
    "flash_fwd": ("flash_fwd.cu", _COMMON, "lara_flash_fwd",
                  [_P] * 6 + [_I] * 5 + [_L] * 6 + [_F, _I, _P]),
    "flash_bwd": ("flash_bwd.cu", _COMMON, "lara_flash_bwd",
                  [_P] * 11 + [_I] * 5 + [_L] * 6 + [_F, _I, _P]),
    "tile_windows": ("tile_windows.cu", _COMMON, "lara_tile_windows",
                     [_P, _I, _P, _I, _I, _P, _P]),
}
_libs: dict = {}
build_log = ""      # nvcc's output (registers, shared memory) of this process's builds


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return str(path)


def build_library() -> dict:
    """Compile (once per source and flags hash) and load every kernel
    library. Returns {name: CDLL} with each entry point's argtypes set."""
    global build_log
    if _libs:
        return _libs
    paths, procs = {}, {}
    headers = b"".join(h.read_bytes() for h in sorted(_CSRC.glob("*.cuh")))
    for name, (src, flags, _, _) in _KERNELS.items():
        src = _CSRC / src
        key = hashlib.sha256(src.read_bytes() + headers + " ".join(flags).encode()).hexdigest()[:16]
        paths[name] = _BUILD_DIR / f"{src.stem}_{key}.so"
        if not paths[name].exists():
            _BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = paths[name].with_suffix(f".{os.getpid()}.tmp")
            procs[name] = (tmp, subprocess.Popen(
                [_nvcc(), *flags, "-o", str(tmp), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = {name: proc.communicate()[0] for name, (_, proc) in procs.items()}
    for name, (tmp, proc) in procs.items():
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed to build {_KERNELS[name][0]}:\n{outs[name]}")
        os.replace(tmp, paths[name])
    build_log = "".join(outs.values())
    libs = {}
    for name, (_, _, sym, argtypes) in _KERNELS.items():
        lib = ctypes.CDLL(str(paths[name]))
        fn = getattr(lib, sym)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        libs[name] = lib
    _libs.update(libs)
    return _libs


def raise_on(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed (cudaError {err})")
