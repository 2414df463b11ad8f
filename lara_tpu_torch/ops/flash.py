"""Flash attention for the ViT encoder: the hand-written CUDA kernels and
their plain PyTorch version, the counterpart of `lara_tpu/ops/flash.py`
(`flash_mha`, which runs JAX's Pallas TPU flash attention).

`flash_mha(q, k, v, scale=None, kv_mask=None)` keeps the JAX layout:
q [B, Lq, h, hd], k and v [B, Lk, h, hd], kv_mask [B, Lk] bool (False keys
are excluded from every query's softmax); it returns [B, Lq, h, hd] in q's
dtype, with `scale` 1/sqrt(hd) by default.
  - CPU tensors run `flash_mha_reference` under ordinary autograd.
  - CUDA tensors launch `csrc/flash_fwd.cu`, and when autograd will need
    the gradients, `_FlashFunction` saves q, k, v, o and the row
    log-sum-exp and its backward launches `csrc/flash_bwd.cu`. bf16 takes
    head_dim 16, 32, ..., 128 (wgmma on TMA-fed shared-memory tiles), f32
    any head_dim up to 128. Anything else raises: there is no fallback to
    the plain version or to a library attention.

`flash_mha_blocked_reference` is a second plain version that walks the
bf16 kernels' blocks (an online softmax over key blocks of 64, P and dS
rounded to bf16 as operands when the inputs are bf16, a backward from the
row log-sum-exp and D = rowsum(dO o)); the tests and `chip_smoke.py` hold
the kernels to it. Nothing on the main path calls either plain version.

The sequences are not padded to a block size in memory (the JAX wrapper
pads to 128 and masks with SegmentIds): the kernels mask the ragged edge
themselves. A key past Lk takes the logit -inf, so its probability is
exactly 0 for every real query, and a query past Lq is never written and
adds nothing to the gradients, so padding cannot change a real row
(`csrc/flash_common.cuh`).

Each wrapper counts its launches in `LAUNCHES`: "flash_fwd" per forward
and "flash_bwd" per backward call, which runs three kernels (the row dot
D, dK/dV, dQ). The libraries are built by `lara_tpu_torch/ops/_build.py`.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from lara_tpu_torch.ops import _build

MAX_HEAD_DIM = 128
LAUNCHES = {"flash_fwd": 0, "flash_bwd": 0}
# the bf16 kernels' blocks: keys per step of the forward's online softmax
# and of the dQ kernel, rows per CTA of every kernel, and queries per step
# of the dK/dV kernel (64 up to head_dim 64, else 32)
BLOCK_K, BLOCK_ROWS = 64, 128


def dkdv_block_q(hd: int) -> int:
    return 64 if hd <= 64 else 32


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def flash_mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        scale: Optional[float] = None,
                        kv_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version: f32 logits (q·kᵀ)·scale, masked keys at -1e9 (as
    `lara_tpu/models/attention.py`), f32 softmax, PV in f32, cast to q's
    dtype. Autocast is off inside so every product stays f32."""
    hd = q.shape[-1]
    scale = 1.0 / math.sqrt(hd) if scale is None else scale
    with torch.autocast(device_type=q.device.type, enabled=False):
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
        if kv_mask is not None:
            logits = torch.where(kv_mask[:, None, None, :], logits, -1e9)
        probs = torch.softmax(logits, dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float())
    return out.to(q.dtype)


def _heads(x: torch.Tensor, rows: int) -> torch.Tensor:
    """[B, L, h, hd] → f32 [B, h, rows, hd], zero rows past L."""
    x = x.float().transpose(1, 2)
    return torch.nn.functional.pad(x, (0, 0, 0, rows - x.shape[2]))


def _ceil(n: int, block: int) -> int:
    return -(-n // block) * block


def _blocked_logits(qb, kb, scale, key0, lk, mask):
    """Logits of query rows qb [B, h, m, hd] against key rows kb [B, h, n,
    hd] from key key0: −1e9 where the padded mask excludes a key, −inf past
    Lk."""
    s = qb @ kb.transpose(-1, -2) * scale
    keys = torch.arange(key0, key0 + kb.shape[2], device=qb.device)
    if mask is not None:
        s = torch.where(mask[:, None, None, key0:key0 + kb.shape[2]], s, -1e9)
    return torch.where(keys < lk, s, -torch.inf)


def _pad_mask(kv_mask, lkp):
    if kv_mask is None:
        return None
    return torch.nn.functional.pad(kv_mask, (0, lkp - kv_mask.shape[1]), value=False)


def _blocked_fwd(q, k, v, kv_mask, scale):
    """(o, lse) by the forward kernel's walk: key blocks of BLOCK_K with the
    online softmax, P rounded to bf16 before P V for bf16 inputs. Query rows
    are independent, so every query block is taken at once, padded with
    zero rows to BLOCK_ROWS."""
    b, lq, h, _ = q.shape
    lk = k.shape[1]
    rnd = q.dtype == torch.bfloat16
    lqp, lkp = _ceil(lq, BLOCK_ROWS), _ceil(lk, BLOCK_K)
    qf, kf, vf = _heads(q, lqp), _heads(k, lkp), _heads(v, lkp)
    mask = _pad_mask(kv_mask, lkp)
    m = torch.full(qf.shape[:3], -torch.inf, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qf)
    for j0 in range(0, lkp, BLOCK_K):
        s = _blocked_logits(qf, kf[:, :, j0:j0 + BLOCK_K], scale, j0, lk, mask)
        m_new = torch.maximum(m, s.amax(-1))     # finite: the block holds a real key
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * corr + p.sum(-1)
        pv = p.bfloat16().float() if rnd else p
        acc = acc * corr[..., None] + pv @ vf[:, :, j0:j0 + BLOCK_K]
        m = m_new
    o = (acc / l[..., None])[:, :, :lq].transpose(1, 2).to(q.dtype)
    return o, (m + torch.log(l))[:, :, :lq].reshape(b * h, lq)


def _blocked_bwd(q, k, v, kv_mask, o, lse, do, scale):
    """(dq, dk, dv) by the backward kernels' walks: D = rowsum(dO o) from the
    forward's o, P from lse, dS = P (dP − D) zero where the key is not live;
    dK, dV summed over query blocks of `dkdv_block_q(hd)`, dQ over key
    blocks of BLOCK_K, with P and dS rounded to bf16 as operands for bf16
    inputs."""
    b, lq, h, hd = q.shape
    lk = k.shape[1]
    rnd = (lambda x: x.bfloat16().float()) if q.dtype == torch.bfloat16 else (lambda x: x)
    lqp, lkp = _ceil(lq, BLOCK_ROWS), _ceil(lk, BLOCK_ROWS)
    qf, kf, vf = _heads(q, lqp), _heads(k, lkp), _heads(v, lkp)
    dof, of = _heads(do.to(q.dtype), lqp), _heads(o, lqp)
    mask = _pad_mask(kv_mask, lkp)
    dsum = (dof * of).sum(-1)
    lse = torch.nn.functional.pad(lse.reshape(b, h, lq), (0, lqp - lq))
    q_ok = torch.arange(lqp, device=q.device) < lq
    live = torch.arange(lkp, device=q.device) < lk
    live = live[None] if mask is None else live[None] & mask

    def p_ds(i0, i1, j0, j1):
        s = _blocked_logits(qf[:, :, i0:i1], kf[:, :, j0:j1], scale, j0, lk, mask)
        p = torch.where(q_ok[i0:i1, None], torch.exp(s - lse[:, :, i0:i1, None]), 0.0)
        dp = dof[:, :, i0:i1] @ vf[:, :, j0:j1].transpose(-1, -2)
        ds = p * (dp - dsum[:, :, i0:i1, None])
        return p, torch.where(live[:, None, None, j0:j1], ds, 0.0)

    dk, dv, dq = torch.zeros_like(kf), torch.zeros_like(vf), torch.zeros_like(qf)
    bq = dkdv_block_q(hd)
    for i0 in range(0, lqp, bq):
        p, ds = p_ds(i0, i0 + bq, 0, lkp)
        dv += rnd(p).transpose(-1, -2) @ dof[:, :, i0:i0 + bq]
        dk += rnd(ds).transpose(-1, -2) @ qf[:, :, i0:i0 + bq]
    for j0 in range(0, lkp, BLOCK_K):
        _, ds = p_ds(0, lqp, j0, j0 + BLOCK_K)
        dq += rnd(ds) @ kf[:, :, j0:j0 + BLOCK_K]

    def back(x, n):
        return x[:, :, :n].transpose(1, 2).to(q.dtype)

    return back(dq * scale, lq), back(dk * scale, lk), back(dv, lk)


class _BlockedFunction(torch.autograd.Function):
    """The blocked plain version as one differentiable op: the forward
    saves o and lse, the backward starts from them, as the kernels do."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, scale):
        with torch.autocast(device_type=q.device.type, enabled=False):
            o, lse = _blocked_fwd(q, k, v, kv_mask, scale)
        ctx.save_for_backward(q, k, v, kv_mask, o, lse)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, kv_mask, o, lse = ctx.saved_tensors
        with torch.autocast(device_type=q.device.type, enabled=False):
            dq, dk, dv = _blocked_bwd(q, k, v, kv_mask, o, lse, do, ctx.scale)
        return dq, dk, dv, None, None


def flash_mha_blocked_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                                scale: Optional[float] = None,
                                kv_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version that walks the bf16 kernels' blocks (module note):
    same signature and result as `flash_mha_reference`, up to where P and
    dS round."""
    _check(q, k, v, kv_mask)
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)
    return _BlockedFunction.apply(q, k, v, kv_mask, scale)


def _check(q, k, v, kv_mask):
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"flash_mha takes q [B, Lq, h, hd] and k, v [B, Lk, h, hd], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, _, h, hd = q.shape
    if k.shape[0] != b or k.shape[2:] != (h, hd):
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree on B, h or hd")
    if q.dtype != k.dtype or q.dtype != v.dtype:
        raise ValueError(f"q, k, v must share a dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if kv_mask is not None and (kv_mask.shape != (b, k.shape[1]) or kv_mask.dtype != torch.bool):
        raise ValueError(f"kv_mask must be bool [{b}, {k.shape[1]}]")
    if not (q.device == k.device == v.device) or (
            kv_mask is not None and kv_mask.device != q.device):
        raise ValueError("flash_mha inputs lie on different devices")


def _kernel_operand(x: torch.Tensor) -> torch.Tensor:
    """x [B, L, h, hd] as the kernels read it: head at stride hd, dimension
    at stride 1, and for bf16 TMA's terms (the batch and row strides
    multiples of 16 bytes, the base 16-byte aligned), which the fused-qkv
    views of the ViT meet in place; else a contiguous copy."""
    hd = x.shape[3]
    ok = x.stride(3) == 1 and x.stride(2) == hd
    if x.dtype == torch.bfloat16:
        ok = ok and x.stride(0) % 8 == 0 and x.stride(1) % 8 == 0 and x.data_ptr() % 16 == 0
    return x if ok else x.contiguous()


def _kernel_dtype(q) -> int:
    hd = q.shape[3]
    if q.dtype == torch.bfloat16 and hd % 16 == 0 and hd <= MAX_HEAD_DIM:
        return 1
    if q.dtype == torch.float32 and hd <= MAX_HEAD_DIM:
        return 0
    raise ValueError(f"the flash kernels take bf16 with head_dim a multiple of 16 up to "
                     f"{MAX_HEAD_DIM}, or f32 with head_dim up to {MAX_HEAD_DIM}; got "
                     f"{q.dtype} head_dim {hd}")


def _shape_args(q, k, v):
    b, lq, h, hd = q.shape
    return (b, h, lq, k.shape[1], hd, q.stride(0), q.stride(1), k.stride(0),
            k.stride(1), v.stride(0), v.stride(1))


def flash_fwd(q, k, v, kv_mask, scale: float):
    """Launch `flash_fwd.cu` on CUDA tensors: (o [B, Lq, h, hd] in q's
    dtype, lse f32 [B·h, Lq])."""
    _check(q, k, v, kv_mask)
    is_bf16 = _kernel_dtype(q)
    q, k, v = (_kernel_operand(x) for x in (q, k, v))
    mask = None if kv_mask is None else kv_mask.contiguous()
    b, lq, h, _ = q.shape
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((b * h, lq), dtype=torch.float32, device=q.device)
    lib = _build.build_library()["flash_fwd"]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.lara_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if mask is None else mask.data_ptr(), o.data_ptr(), lse.data_ptr(),
            *_shape_args(q, k, v), float(scale), is_bf16, stream)
    _build.raise_on(err, "flash_fwd")
    LAUNCHES["flash_fwd"] += 1
    return o, lse


def flash_bwd(q, k, v, kv_mask, o, lse, do, scale: float):
    """Launch `flash_bwd.cu` on CUDA tensors: (dq, dk, dv), contiguous, in
    q's dtype, from the forward's o and lse and the cotangent `do` of o."""
    _check(q, k, v, kv_mask)
    b, lq, h, _ = q.shape
    if o.shape != q.shape or do.shape != q.shape or lse.shape != (b * h, lq):
        raise ValueError("flash_bwd takes o and do shaped as q and lse [B·h, Lq]")
    is_bf16 = _kernel_dtype(q)
    q, k, v = (_kernel_operand(x) for x in (q, k, v))
    mask = None if kv_mask is None else kv_mask.contiguous()
    do = do.to(q.dtype).contiguous()
    o, lse = o.contiguous(), lse.contiguous()
    dsum = torch.empty_like(lse)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dk = torch.empty(k.shape, dtype=q.dtype, device=q.device)
    dv = torch.empty(v.shape, dtype=q.dtype, device=q.device)
    lib = _build.build_library()["flash_bwd"]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.lara_flash_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if mask is None else mask.data_ptr(), o.data_ptr(), do.data_ptr(),
            lse.data_ptr(), dsum.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            *_shape_args(q, k, v), float(scale), is_bf16, stream)
    _build.raise_on(err, "flash_bwd")
    LAUNCHES["flash_bwd"] += 1
    return dq, dk, dv


def kernel_smem(hd: int) -> dict:
    """Dynamic shared memory per CTA (bytes) of the bf16 kernels at
    head_dim hd, as their launches ask for it."""
    libs = _build.build_library()
    fwd, bwd = libs["flash_fwd"].lara_flash_fwd_smem, libs["flash_bwd"].lara_flash_bwd_smem
    fwd.argtypes, bwd.argtypes = [ctypes.c_int], [ctypes.c_int, ctypes.c_int]
    return {"fwd_bf16": fwd(hd), "dkdv_bf16": bwd(0, hd), "dq_bf16": bwd(1, hd)}


class _FlashFunction(torch.autograd.Function):
    """The forward and backward kernels as one differentiable op (the
    counterpart of the custom VJP of JAX's flash attention). Under
    `torch.utils.checkpoint` the recompute runs this forward again, so it
    launches the same kernel."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, scale):
        o, lse = flash_fwd(q, k, v, kv_mask, scale)
        ctx.save_for_backward(q, k, v, kv_mask, o, lse)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, kv_mask, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, kv_mask, o, lse, do, ctx.scale)
        return dq, dk, dv, None, None


def flash_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              scale: Optional[float] = None,
              kv_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Multi-head softmax attention, q [B, Lq, h, hd], k/v [B, Lk, h, hd],
    kv_mask [B, Lk] bool → [B, Lq, h, hd] in q's dtype. CUDA tensors
    launch the kernels; CPU tensors take the plain version."""
    _check(q, k, v, kv_mask)
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)
    dev = q.device
    if dev.type == "cpu":
        return flash_mha_reference(q, k, v, scale=scale, kv_mask=kv_mask)
    if dev.type != "cuda":
        raise ValueError(f"flash_mha runs on cuda or cpu tensors, not {dev}")
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return _FlashFunction.apply(q, k, v, kv_mask, scale)
    return flash_fwd(q, k, v, kv_mask, scale)[0]
