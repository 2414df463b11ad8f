"""JAX parameter tree → this package's state dict: the inverse of
`lara_tpu/models/convert.py:convert_network_state_dict`.

`params_from_jax(tree)` takes `LaRaNet.init(...)["params"]` of the JAX
package as numpy arrays (scanned layer stacks with a leading layer axis)
and returns the reference-named state dict that `lara_tpu_torch.LaRaNet`
loads:
  - Dense kernels [in, out] → Linear weights [out, in];
  - the ViT's separate q/k/v projections → timm's joint `qkv`;
  - Conv [kh, kw, (kd,) in, out] → [out, in, kh, kw, (kd)];
  - ConvTranspose [kd, kh, kw, in, out], taps flipped back → [in, out, kd, kh, kw];
  - view_embed [1, 4, C] → [1, 4, C, 1, 1, 1];
  - vol pos_embed channel-last → channel-first.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _layer(tree: Mapping, i: int) -> Dict[str, Any]:
    """Slice layer `i` out of a scanned (leading-axis) parameter stack."""
    return {k: _layer(v, i) if isinstance(v, Mapping) else np.asarray(v)[i]
            for k, v in tree.items()}


def _linear(sd, key, p):
    sd[key + ".weight"] = _t(np.asarray(p["kernel"]).T)
    if "bias" in p:
        sd[key + ".bias"] = _t(p["bias"])


def _layernorm(sd, key, p):
    sd[key + ".weight"] = _t(p["scale"])
    sd[key + ".bias"] = _t(p["bias"])


def _mha(sd, key, p):
    for name in ("q", "k", "v"):
        sd[f"{key}.{name}_proj_weight"] = _t(np.asarray(p[f"{name}_proj"]["kernel"]).T)
    sd[key + ".out_proj.weight"] = _t(np.asarray(p["out_proj"]["kernel"]).T)


def _vit(sd, pre, p):
    pe = np.asarray(p["patch_embed"]["kernel"])          # [kh, kw, in, out]
    sd[pre + "patch_embed.proj.weight"] = _t(pe.transpose(3, 2, 0, 1))
    sd[pre + "patch_embed.proj.bias"] = _t(p["patch_embed"]["bias"])
    sd[pre + "cls_token"] = _t(p["cls_token"])
    sd[pre + "pos_embed"] = _t(p["pos_embed"])
    stack = p["blocks"]["block"]
    for i in range(np.asarray(stack["norm1"]["scale"]).shape[0]):
        blk, key = _layer(stack, i), f"{pre}blocks.{i}."
        att = blk["attn"]
        sd[key + "attn.qkv.weight"] = _t(np.concatenate(
            [att[f"{n}_proj"]["kernel"].T for n in "qkv"], axis=0))
        sd[key + "attn.qkv.bias"] = _t(np.concatenate(
            [att[f"{n}_proj"]["bias"] for n in "qkv"], axis=0))
        _linear(sd, key + "attn.proj", att["out_proj"])
        _layernorm(sd, key + "norm1", blk["norm1"])
        _layernorm(sd, key + "norm2", blk["norm2"])
        _linear(sd, key + "mlp.fc1", blk["mlp"]["fc1"])
        _linear(sd, key + "mlp.fc2", blk["mlp"]["fc2"])
    _layernorm(sd, pre + "norm", p["norm"])


def params_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """JAX `LaRaNet` params (the tree under "params") → state dict."""
    sd: Dict[str, torch.Tensor] = {}
    _vit(sd, "img_encoder.model.", tree["img_encoder"])
    _layernorm(sd, "dir_norm.norm", tree["dir_norm"]["norm"])
    _linear(sd, "dir_norm.mlp.1", tree["dir_norm"]["mlp"])
    if "view_embed" in tree:
        ve = np.asarray(tree["view_embed"])
        sd["view_embed"] = _t(ve.reshape(*ve.shape, 1, 1, 1))

    vol = tree["vol_decoder"]
    if "layers" not in vol:
        raise NotImplementedError("only the scanned (single n_groups) layer stack is supported")
    sd["vol_decoder.pos_embed"] = _t(np.asarray(vol["pos_embed"]).transpose(0, 4, 1, 2, 3))
    stack = vol["layers"]["block"]
    for i in range(np.asarray(stack["norm1"]["scale"]).shape[0]):
        blk, key = _layer(stack, i), f"vol_decoder.layers.{i}."
        for nm in ("norm1", "norm2", "norm3"):
            _layernorm(sd, key + nm, blk[nm])
        _mha(sd, key + "cross_attn", blk["cross_attn"])
        _linear(sd, key + "mlp.0", blk["mlp"]["fc1"])
        _linear(sd, key + "mlp.3", blk["mlp"]["fc2"])
        # [kd, kh, kw, in, out] → [out, in, kd, kh, kw]
        sd[key + "cnn.weight"] = _t(blk["cnn"]["kernel"].transpose(4, 3, 0, 1, 2))
    _layernorm(sd, "vol_decoder.norm", vol["norm"])
    dk = np.asarray(vol["deconv"]["kernel"])[::-1, ::-1, ::-1]   # taps flipped back
    sd["vol_decoder.deconv.weight"] = _t(dk.transpose(3, 4, 0, 1, 2))
    sd["vol_decoder.deconv.bias"] = _t(vol["deconv"]["bias"])

    dc, df = tree["decoder_coarse"], tree["decoder_fine"]
    _linear(sd, "decoder.mlp_coarse.0", dc["fc0"])
    _linear(sd, "decoder.mlp_coarse.2", dc["fc1"])
    _linear(sd, "decoder.mlp_coarse.4", dc["out"])
    _layernorm(sd, "decoder.norm", df["norm"])
    _mha(sd, "decoder.cross_att", df["cross_att"])
    _linear(sd, "decoder.mlp_fine.0", df["fc0"])
    _linear(sd, "decoder.mlp_fine.2", df["fc1"])
    return sd
