"""The port's flash attention against the JAX package's.

`flash_mha` on CPU tensors runs the plain version (`flash_mha_reference`);
it is held against `lara_tpu.ops.flash.flash_mha`, which runs JAX's Pallas
TPU flash-attention kernels in interpret mode off the TPU, on the same
numpy-made inputs, in f32, at the bars of tests/test_flash.py: 2e-5 on the
output (L = 200, ragged against the kernel's 128 block, with and without a
random kv_mask), 5e-5 on the gradients of q, k and v (L = 130), 1e-4 for
the attention module and 3e-4 for the ViT (2 layers, dim 64, 64² input;
JAX remat off, as the interpreter's effect is rejected by jax.remat).
`flash_mha_blocked_reference`, which walks the bf16 kernels' blocks, is
held against the JAX flash attention at L = 257 with a one-row tail (values
and gradients, with and without kv_mask) and against the plain version in
bf16; `_kernel_operand` keeps the fused-qkv views in place for TMA.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lara_tpu.models.vit import DinoViT as JaxDinoViT
from lara_tpu.ops.flash import flash_mha as jax_flash_mha
from lara_tpu_torch.models.convert import _vit
from lara_tpu_torch.models.vit import DinoViT, TimmAttention
from lara_tpu_torch.ops import _build, flash
from tests.test_torch_blend import one_torch_thread  # noqa: F401


def qkv_np(b=2, lq=200, lk=None, h=2, hd=32, seed=0):
    rng = np.random.default_rng(seed)
    lk = lq if lk is None else lk
    return (rng.normal(size=(b, lq, h, hd)).astype(np.float32),
            rng.normal(size=(b, lk, h, hd)).astype(np.float32),
            rng.normal(size=(b, lk, h, hd)).astype(np.float32))


def kv_mask_np(b, lk, seed):
    mask = np.random.default_rng(seed).uniform(size=(b, lk)) > 0.3
    mask[:, 0] = True                  # every row keeps at least one key
    return mask


@pytest.mark.parametrize("masked", [False, True])
def test_flash_matches_jax(masked):
    q, k, v = qkv_np(seed=int(masked))
    mask = kv_mask_np(2, 200, 7) if masked else None
    want = jax_flash_mha(*(jnp.asarray(a) for a in (q, k, v)),
                         kv_mask=None if mask is None else jnp.asarray(mask))
    got = flash.flash_mha(*(torch.from_numpy(a) for a in (q, k, v)),
                          kv_mask=None if mask is None else torch.from_numpy(mask))
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)


def test_flash_grads_match_jax():
    import jax

    q, k, v = qkv_np(b=1, lq=130, seed=2)
    want = jax.grad(lambda *a: (jax_flash_mha(*a) ** 2).sum(), argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in (q, k, v)))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    (flash.flash_mha(*ts) ** 2).sum().backward()
    for t, w, name in zip(ts, want, "qkv"):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=5e-5, rtol=5e-5,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("masked", [False, True])
def test_blocked_reference_matches_jax(masked):
    """The blocked plain version (the bf16 kernels' walk: key blocks of 64,
    rows padded to 128) against JAX's flash attention in f32 at L = 257 =
    2·128 + 1, a one-row tail on both the port's and the JAX kernel's
    blocks: values within 2e-5, gradients of q, k, v within 5e-5."""
    import jax

    q, k, v = qkv_np(b=2, lq=257, seed=10 + int(masked))
    mask = kv_mask_np(2, 257, 11) if masked else None
    jmask = None if mask is None else jnp.asarray(mask)
    tmask = None if mask is None else torch.from_numpy(mask)

    def jax_loss(*a):
        return (jax_flash_mha(*a, kv_mask=jmask) ** 2).sum()

    jargs = [jnp.asarray(a) for a in (q, k, v)]
    want = jax_flash_mha(*jargs, kv_mask=jmask)
    want_grads = jax.grad(jax_loss, argnums=(0, 1, 2))(*jargs)
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    got = flash.flash_mha_blocked_reference(*ts, kv_mask=tmask)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)
    (got ** 2).sum().backward()
    for t, w, name in zip(ts, want_grads, "qkv"):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=5e-5, rtol=5e-5,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("hd,masked", [(32, False), (80, True)])
def test_blocked_reference_matches_plain_bf16(hd, masked):
    """In bf16 the blocked version rounds P and dS to bf16 as the kernels
    do, and stays within the bar the kernels meet against the plain version
    (chip_smoke.py: relative L2 1e-2, every element within 2^-5 of the
    largest); in f32 the two agree to float rounding."""
    q, k, v = qkv_np(b=2, lq=257, h=2, hd=hd, seed=12)
    do = np.random.default_rng(13).normal(size=q.shape).astype(np.float32)
    mask = torch.from_numpy(kv_mask_np(2, 257, 14)) if masked else None
    for dtype, rel_bar, max_bar in ((torch.bfloat16, 1e-2, 2.0 ** -5), (torch.float32, 1e-5, 1e-5)):
        outs = []
        for fn in (flash.flash_mha_blocked_reference, flash.flash_mha_reference):
            ts = [torch.from_numpy(a).to(dtype).requires_grad_(True) for a in (q, k, v)]
            o = fn(*ts, kv_mask=mask)
            assert o.dtype == dtype and o.shape == ts[0].shape
            outs.append([o, *torch.autograd.grad(o, ts, torch.from_numpy(do).to(dtype))])
        for name, g, w in zip(("o", "dq", "dk", "dv"), *outs):
            g, w = g.float(), w.float()
            rel = ((g - w).norm() / w.norm()).item()
            err = (g - w).abs().max().item()
            assert rel <= rel_bar and err <= max_bar * w.abs().max().item(), (dtype, name, rel, err)


def test_kernel_operand_keeps_tma_views():
    """The fused-qkv views the ViT passes (row stride 3·h·hd) meet TMA's
    terms and are read in place; a view whose row stride or base is not a
    multiple of 16 bytes, or whose head is not at stride hd, is copied."""
    b, l, h, hd = 2, 33, 3, 64
    qkv = torch.zeros(b, l, 3 * h * hd, dtype=torch.bfloat16)
    for t in qkv.chunk(3, dim=-1):
        view = t.reshape(b, l, h, hd)
        assert flash._kernel_operand(view) is view
    odd_row = torch.zeros(b, l, h * hd + 4, dtype=torch.bfloat16)[..., :h * hd].reshape(b, l, h, hd)
    odd_base = torch.zeros(b, l, h * hd + 1, dtype=torch.bfloat16)[..., 1:].reshape(b, l, h, hd)
    heads_apart = torch.zeros(b, l, h, 2 * hd, dtype=torch.bfloat16)[..., :hd]
    for view in (odd_row, odd_base, heads_apart):
        got = flash._kernel_operand(view)
        assert got is not view and got.is_contiguous() and torch.equal(got, view)
    f32 = torch.zeros(b, l, 3 * h * 12)[..., 4:4 + h * 12].reshape(b, l, h, 12)
    assert flash._kernel_operand(f32) is f32      # the f32 kernels take any row stride


def test_timm_attention_flash_parity():
    """TimmAttention(use_flash=True) ≡ the plain attention, same weights."""
    torch.manual_seed(0)
    ref = TimmAttention(64, 2)
    fl = TimmAttention(64, 2, use_flash=True)
    fl.load_state_dict(ref.state_dict())
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(2, 150, 64)).astype(np.float32))
    with torch.no_grad():
        np.testing.assert_allclose(fl(x).numpy(), ref(x).numpy(), atol=1e-4, rtol=1e-4)


def test_vit_flash_matches_jax():
    """The port's DinoViT(use_flash=True) against JAX DinoViT(use_flash=True)
    on the same weights (the CLS token makes L = 17, ragged)."""
    import jax

    img = np.random.default_rng(4).uniform(size=(1, 64, 64, 3)).astype(np.float32)
    kwargs = dict(patch_size=16, dim=64, depth=2, num_heads=2, dtype=jnp.float32,
                  remat=False, use_flash=True)
    jmod = JaxDinoViT(**kwargs)
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(img))
    want = jmod.apply(params, jnp.asarray(img))
    sd = {}
    _vit(sd, "model.", jax.tree.map(np.asarray, params["params"]))
    tmod = DinoViT(64, 2, 2, 16, use_flash=True)
    tmod.load_state_dict(sd, strict=True)
    assert all(blk.attn.use_flash for blk in tmod.model.blocks)
    with torch.no_grad():
        got = tmod(torch.from_numpy(img))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-4, rtol=3e-4)


def test_flash_rejects_bad_inputs():
    q, k, v = (torch.from_numpy(a) for a in qkv_np(b=1, lq=20, h=2, hd=16))
    with pytest.raises(ValueError, match="cuda or cpu"):
        flash.flash_mha(q.to("meta"), k.to("meta"), v.to("meta"))
    with pytest.raises(ValueError, match="B, h or hd"):
        flash.flash_mha(q, k[..., :8], v[..., :8])
    with pytest.raises(ValueError, match="share a dtype"):
        flash.flash_mha(q, k.double(), v)
    with pytest.raises(ValueError, match="kv_mask"):
        flash.flash_mha(q, k, v, kv_mask=torch.ones(1, 19, dtype=torch.bool))
    with pytest.raises(ValueError, match="head_dim"):
        flash.flash_fwd(q.bfloat16()[..., :12], k.bfloat16()[..., :12],
                        v.bfloat16()[..., :12], None, 0.1)
    # the CPU path never counts as a kernel launch
    before = dict(flash.LAUNCHES)
    flash.flash_mha(q.requires_grad_(True), k, v).sum().backward()
    assert flash.LAUNCHES == before


def test_failed_flash_build_raises(monkeypatch, tmp_path):
    """Without nvcc the kernels' build raises on the way to a launch."""
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "_BUILD_DIR", tmp_path)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    q, k, v = (torch.from_numpy(a) for a in qkv_np(b=1, lq=20, h=2, hd=16))
    with pytest.raises(RuntimeError, match="nvcc"):
        flash.flash_fwd(q, k, v, None, 0.25)


@pytest.mark.cuda
def test_flash_kernels_match_reference_on_cuda():
    """The bf16 kernels against autograd of the plain version on the card,
    at a ragged length with a kv_mask; skipped without a GPU. Bars follow
    from bf16 rounding of P and dS before their products (chip_smoke.py)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    q, k, v = (torch.from_numpy(a).cuda().bfloat16().requires_grad_(True)
               for a in qkv_np(b=2, lq=200, h=2, hd=64))
    mask = torch.from_numpy(kv_mask_np(2, 200, 7)).cuda()
    do = torch.randn_like(q)
    got = [flash.flash_mha(q, k, v, kv_mask=mask)]
    got += torch.autograd.grad(got[0], (q, k, v), do)
    want = [flash.flash_mha_reference(q, k, v, kv_mask=mask)]
    want += torch.autograd.grad(want[0], (q, k, v), do)
    for g, w in zip(got, want):
        err = (g.float() - w.float()).norm() / w.float().norm()
        assert err <= 1e-2, err


def test_profile_flash_bounds_and_views():
    """The flash profiler's bound at the ViT's train shape (the one chip_smoke
    reports: forward 3.87e10 flops, backward 2.5 times that, both
    operation-bound at 989 TFLOP/s), its fused-qkv views read in place, and
    no run without a card."""
    from lara_tpu_torch.tools import profile_flash

    bnd = profile_flash.bounds_ms(12, 1025, 12, 64)
    assert bnd["fwd"][1] == bnd["bwd"][1] == "operations"
    np.testing.assert_allclose(bnd["fwd"][0], 4.0 * 12 * 12 * 1025 ** 2 * 64 / 989e12 * 1e3)
    np.testing.assert_allclose(bnd["bwd"][0], 2.5 * bnd["fwd"][0])
    q, k, v, do = profile_flash.fused_qkv(2, 17, 3, 16, torch.bfloat16, "cpu")
    assert q.shape == do.shape == (2, 17, 3, 16) and q.stride(1) == 3 * 3 * 16
    assert all(flash._kernel_operand(x) is x for x in (q, k, v))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            profile_flash.run()
