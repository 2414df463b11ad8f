"""Where the time of the flash-attention kernels goes, on one CUDA GPU.

    python -m lara_tpu_torch.tools.profile_flash [--reps 50]

Run from the repository root. At the ViT's bf16 shapes, [12, 1025, 12, 64]
(a flagship train micro-step: 3 scenes of 4 input views) and
[4, 1025, 12, 64] (a serving request), with q, k and v taken as views of one
fused [B, 1025, 2304] projection as the ViT passes them, it prints:
  1. the `nvidia-smi` name and power limit of the card;
  2. device ms per call of `flash_fwd` and `flash_bwd`, queued behind a
     sleep kernel (`queued_ms`, so the wrapper's host cost is not in it),
     beside the bound (the larger of the bytes over 3.35 TB/s and the
     flops over 989 TFLOP/s; the backward's five products of FlashAttention-2)
     and the share of it;
  3. each kernel's device time per call under `torch.profiler`: the
     forward, and the backward's row dot D, dK/dV and dQ;
  4. `F.scaled_dot_product_attention` under each backend that runs at the
     shape, forward and backward, queued the same way: the yardstick only,
     the port never calls it.
"""

from __future__ import annotations

import argparse

import torch
import torch.nn.functional as F

from lara_tpu_torch.ops import flash
from lara_tpu_torch.tools.timing import queued_ms

HBM_BYTES_PER_S, BF16_TC_FLOPS = 3.35e12, 989e12
SHAPES = {"train": (12, 1025, 12, 64), "serve": (4, 1025, 12, 64)}


def fused_qkv(b, l, h, hd, dtype, device, seed=0):
    """q, k, v [b, l, h, hd] as views of one seeded [b, l, 3·h·hd] tensor,
    and a seeded cotangent."""
    gen = torch.Generator().manual_seed(seed)
    qkv = torch.randn((b, l, 3 * h * hd), generator=gen).to(device, dtype)
    q, k, v = (t.reshape(b, l, h, hd) for t in qkv.chunk(3, dim=-1))
    return q, k, v, torch.randn((b, l, h, hd), generator=gen).to(device, dtype)


def bounds_ms(b, l, h, hd) -> dict:
    """Least device ms of the forward and the backward at bf16 [b, l, h, hd]:
    bytes (q, k, v, o, lse; the backward also dO, dq, dk, dv) over the
    memory rate against 4 b h l² hd flops (forward) and 2.5 times that
    (backward) over the tensor-core rate."""
    io, lse = 4 * b * l * h * hd * 2, b * h * l * 4
    flops = 4.0 * b * h * l * l * hd
    out = {}
    for name, nbytes, ops in (("fwd", io + lse, flops),
                              ("bwd", io + lse + 4 * b * l * h * hd * 2, 2.5 * flops)):
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / BF16_TC_FLOPS
        out[name] = (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")
    return out


def sdpa_ms(q, k, v, do) -> dict:
    """{backend: (forward ms, backward ms)}: queued device ms of one
    `F.scaled_dot_product_attention` call and of its backward on the same
    views, in its [b, h, l, hd] layout, under each backend that runs at the
    shape."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    sq, sk, sv, sdo = (x.transpose(1, 2) for x in (q, k, v, do))
    res = {}
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.CUDNN_ATTENTION):
        name = backend.name.lower()
        try:
            with sdpa_kernel(backend):
                with torch.no_grad():
                    fwd = queued_ms(lambda: F.scaled_dot_product_attention(sq, sk, sv))
                leaves = [x.detach().requires_grad_(True) for x in (sq, sk, sv)]
                so = F.scaled_dot_product_attention(*leaves)
                bwd = queued_ms(lambda: torch.autograd.grad(so, leaves, sdo, retain_graph=True))
            res[name] = (fwd, bwd)
            print(f"[flash] SDPA {name}: fwd {fwd:.4f} ms bwd {bwd:.4f} ms (queued device time)")
        except RuntimeError as e:
            print(f"[flash] SDPA {name}: does not run here ({str(e).splitlines()[0][:120]})")
    if not res:
        raise RuntimeError("no SDPA backend runs at this shape")
    return res


def kernel_times(q, k, v, do, reps=10) -> dict:
    """{kernel name: device µs per call} of `reps` forward and backward
    calls under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    scale = q.shape[-1] ** -0.5
    o, lse = flash.flash_fwd(q, k, v, None, scale)
    flash.flash_bwd(q, k, v, None, o, lse, do, scale)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flash.flash_fwd(q, k, v, None, scale)
            flash.flash_bwd(q, k, v, None, o, lse, do, scale)
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    total = {}
    for e in prof.events():
        if e.device_type == cuda:
            name = e.name.replace("void ", "").replace("(anonymous namespace)::", "")
            name = name.split("(")[0]
            total[name] = total.get(name, 0.0) + e.time_range.elapsed_us()
    return {name: us / reps for name, us in total.items()}


def run(reps: int = 50) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("profile_flash needs a CUDA device")
    from chip_smoke import nvidia_smi_line

    print(nvidia_smi_line())
    res = {}
    for name, shape in SHAPES.items():
        q, k, v, do = fused_qkv(*shape, torch.bfloat16, "cuda")
        scale = shape[-1] ** -0.5
        o, lse = flash.flash_fwd(q, k, v, None, scale)
        ms = {"fwd": queued_ms(lambda: flash.flash_fwd(q, k, v, None, scale), reps),
              "bwd": queued_ms(lambda: flash.flash_bwd(q, k, v, None, o, lse, do, scale), reps)}
        bnd = bounds_ms(*shape)
        for what in ("fwd", "bwd"):
            print(f"[flash] {name} {list(shape)} {what}: {ms[what]:.4f} ms queued; bound "
                  f"{bnd[what][0]:.4f} ms ({bnd[what][1]}), {bnd[what][0] / ms[what]:.3f} of it")
        per_kernel = kernel_times(q, k, v, do)
        print(f"[flash] {name} device µs per call: "
              + ", ".join(f"{k_} {us:.2f}" for k_, us in per_kernel.items()))
        res[name] = {"ms": ms, "bound": bnd, "kernels": per_kernel, "sdpa": sdpa_ms(q, k, v, do)}
    print(nvidia_smi_line())
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="time the flash-attention kernels")
    ap.add_argument("--reps", type=int, default=50)
    run(ap.parse_args(argv).reps)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
