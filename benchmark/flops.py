"""Model FLOPs of LaRa: the products of the network's forward, counted from
the configuration's shapes (matrix products and convolutions only; the
rasterizer's arithmetic is counted apart, as the blend kernels' work, and
element-wise operations are not counted). A training micro-step counts the
forward three times (forward and backward), whatever the program
recomputes under remat.
"""

from __future__ import annotations

from typing import Dict

PEAK_BF16 = 989e12   # dense bf16 tensor-core FLOP/s of one H100 SXM


def forward_components(entry: Dict, b: int, size: int) -> Dict[str, float]:
    """Forward FLOPs of `b` scenes of size² input views, by stage."""
    m = entry["model"]
    n_in = entry["n_views"]
    h = w = size
    p = m["patch_size"]
    tokens = (h // p) * (w // p) + 1
    d = m["encoder_dim"]
    vit = m["encoder_depth"] * (24 * tokens * d * d + 4 * tokens * tokens * d)
    vit = b * n_in * (vit + 2 * (tokens - 1) * (3 * p * p) * d)

    r = m["vol_embedding_reso"]
    t = r ** 3
    e = m["embedding_dim"]
    block = r // m["n_groups"][0]
    cond_tokens = (r // block) ** 3 * n_in * block ** 3
    cond_dim = d + m["view_embed_dim"]
    layer = (4 * t * e * e + 4 * cond_tokens * cond_dim * e + 4 * t * (n_in * block ** 3) * e
             + 8 * t * e * e + 2 * (3 * r - 2) ** 3 * e * e)
    out_dim = m["vol_embedding_out_dim"]
    vol = b * (m["num_layers"] * layer + 2 * 8 * t * e * out_dim)

    voxels = (2 * r) ** 3
    sh = (m["sh_degree"] + 1) ** 2 * 3
    row = 3 + sh + 1 + 2 + 4
    dec = b * (2 * 2 * voxels * out_dim * out_dim + 2 * voxels * out_dim * row * m["K"])

    mf = b * m["fine_budget"]
    fine = (4 * mf * out_dim * out_dim + 4 * mf * n_in * 8 * out_dim + 4 * mf * n_in * out_dim
            + 2 * mf * out_dim * 64 + 2 * mf * 64 * sh)
    return {"vit": float(vit), "vol": float(vol), "dec": float(dec), "fine": float(fine)}


def train_step(entry: Dict, b: int, size: int) -> float:
    """FLOPs of one training micro-step of `b` scenes (forward × 3)."""
    return 3.0 * sum(forward_components(entry, b, size).values())


def serve_step(entry: Dict, b: int, size: int) -> float:
    """FLOPs of one serving request of `b` scenes (forward)."""
    return sum(forward_components(entry, b, size).values())
