"""Seeded weights of the LaRa network, made on the device in two draws.

The initialisation is the JAX package's and the program's: xavier-uniform
dense and attention projections, lecun-normal convolutions, zero biases,
unit LayerNorms, normal position and view embeddings. The names and shapes
come from the benchmark's own reference module, so the program and the
reference load one dict made here.
"""

from __future__ import annotations

import math
from collections import OrderedDict

import torch
import torch.nn as nn


def _rules(net: nn.Module, model: dict):
    """{name: ("uniform", bound) | ("normal", std) | ("const", value)}."""
    rules = {}
    names = {id(p): n for n, p in net.named_parameters()}
    for mod in net.modules():
        if isinstance(mod, nn.Linear):
            fo, fi = mod.weight.shape
            rules[names[id(mod.weight)]] = ("uniform", math.sqrt(6.0 / (fi + fo)))
        elif isinstance(mod, (nn.Conv2d, nn.Conv3d, nn.ConvTranspose3d)):
            w = mod.weight
            fan_in = (w.shape[0] if isinstance(mod, nn.ConvTranspose3d) else w.shape[1]) \
                * math.prod(w.shape[2:])
            rules[names[id(w)]] = ("normal", fan_in ** -0.5)
        elif isinstance(mod, nn.LayerNorm):
            rules[names[id(mod.weight)]] = ("const", 1.0)
        for pn in ("q_proj_weight", "k_proj_weight", "v_proj_weight"):
            p = getattr(mod, pn, None)
            if isinstance(p, nn.Parameter):
                fo, fi = p.shape
                rules[names[id(p)]] = ("uniform", math.sqrt(6.0 / (fi + fo)))
        if getattr(mod, "bias", None) is not None and isinstance(mod.bias, nn.Parameter):
            rules[names[id(mod.bias)]] = ("const", 0.0)
    rules["img_encoder.model.cls_token"] = ("const", 0.0)
    rules["img_encoder.model.pos_embed"] = ("normal", 0.02)
    rules["view_embed"] = ("normal", model["view_embed_dim"] ** -0.5)
    rules["vol_decoder.pos_embed"] = ("normal", model["embedding_dim"] ** -0.5)
    missed = [n for n in names.values() if n not in rules]
    if missed:
        raise RuntimeError(f"parameters without an initializer: {missed}")
    return rules


def make(net: nn.Module, model: dict, seed: int, device) -> "OrderedDict[str, torch.Tensor]":
    """Float32 weights of every parameter of `net` from `seed`, on `device`."""
    rules = _rules(net, model)
    shapes = OrderedDict((n, p.shape) for n, p in net.named_parameters())
    gen = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    sizes = {kind: sum(math.prod(shapes[n]) for n, r in rules.items() if r[0] == kind)
             for kind in ("uniform", "normal")}
    draws = {"uniform": torch.rand(sizes["uniform"], generator=gen, device=device) * 2.0 - 1.0,
             "normal": torch.randn(sizes["normal"], generator=gen, device=device)}
    at = {"uniform": 0, "normal": 0}
    out = OrderedDict()
    for n, shape in shapes.items():
        kind, val = rules[n]
        if kind == "const":
            out[n] = torch.full(shape, val, device=device)
            continue
        k = math.prod(shape)
        out[n] = (draws[kind][at[kind]:at[kind] + k] * val).reshape(shape)
        at[kind] += k
    return out
