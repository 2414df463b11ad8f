"""Real spherical harmonics (Cartesian form), the counterpart of
`lara_tpu/utils/sh.py`: Ynm at index n*(n+1)+m, degree-1 row
[c0, -c1*y, c1*z, -c1*x] — the basis of the reference's `tools/rsh.py` and
of the 2DGS CUDA `computeColorFromSH`.
"""

from __future__ import annotations

import torch

_C0 = 0.28209479177387814
_C1 = 0.4886025119029199
_C2 = (
    1.0925484305920792,
    -1.0925484305920792,
    0.31539156525252005,
    -1.0925484305920792,
    0.5462742152960396,
)
_C3 = (
    -0.5900435899266435,
    2.890611442640554,
    -0.4570457994644658,
    0.3731763325901154,
    -0.4570457994644658,
    1.445305721320277,
    -0.5900435899266435,
)


def rsh_cart(xyz: torch.Tensor, degree: int) -> torch.Tensor:
    """Real SH basis up to `degree` (≤ 3) for unit vectors `xyz [..., 3]`
    → [..., (degree+1)**2]."""
    if degree > 3:
        raise NotImplementedError("SH degree > 3 is not used by LaRa")
    x, y, z = xyz.unbind(-1)
    out = [torch.full_like(x, _C0)]
    if degree >= 1:
        out += [-_C1 * y, _C1 * z, -_C1 * x]
    if degree >= 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        out += [
            _C2[0] * xy,
            _C2[1] * yz,
            _C2[2] * (2.0 * zz - xx - yy),
            _C2[3] * xz,
            _C2[4] * (xx - yy),
        ]
    if degree >= 3:
        out += [
            _C3[0] * y * (3.0 * xx - yy),
            _C3[1] * xy * z,
            _C3[2] * y * (4.0 * zz - xx - yy),
            _C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
            _C3[4] * x * (4.0 * zz - xx - yy),
            _C3[5] * z * (xx - yy),
            _C3[6] * x * (xx - 3.0 * yy),
        ]
    return torch.stack(out, dim=-1)


def rsh_cart_3(xyz: torch.Tensor) -> torch.Tensor:
    """Degree-3 basis (16 values), the ray-direction encoding of
    lightning/network.py:8,366."""
    return rsh_cart(xyz, 3)


def eval_sh_color(shs: torch.Tensor, dirs: torch.Tensor, degree: int) -> torch.Tensor:
    """shs [..., (degree+1)**2, 3], dirs [..., 3] unit → RGB [..., 3]:
    basis-weighted sum + 0.5, clamped to >= 0 (computeColorFromSH)."""
    basis = rsh_cart(dirs, degree)
    rgb = torch.sum(basis[..., None] * shs, dim=-2) + 0.5
    return torch.clamp(rgb, min=0.0)
