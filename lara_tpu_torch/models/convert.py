"""JAX parameter tree → this package's state dict: the inverse of
`lara_tpu/models/convert.py:convert_network_state_dict`.

`params_from_jax(tree)` takes `LaRaNet.init(...)["params"]` of the JAX
package as numpy arrays (scanned layer stacks with a leading layer axis;
the volume transformer's `layer0 … layer{L-1}` where `model.n_groups`
gives more than one block size) and returns the reference-named state
dict that `lara_tpu_torch.LaRaNet` loads:
  - Dense kernels [in, out] → Linear weights [out, in];
  - the ViT's separate q/k/v projections → timm's joint `qkv`;
  - Conv [kh, kw, (kd,) in, out] → [out, in, kh, kw, (kd)];
  - ConvTranspose [kd, kh, kw, in, out], taps flipped back → [in, out, kd, kh, kw];
  - view_embed [1, 4, C] → [1, 4, C, 1, 1, 1];
  - vol pos_embed channel-last → channel-first.

`load_lightning_checkpoint(path)` reads the reference's Lightning
checkpoint (the released `epoch=29.ckpt`) or a bare state dict: the port's
parameters carry the reference's names, so its work is to unpickle without
the classes the file names (Lightning, OmegaConf), strip `net.`, and keep
exactly the keys the JAX package's converter reads.
"""

from __future__ import annotations

import pickle
import types
from typing import Any, Dict, List, Mapping, Optional, Tuple

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
    sd["vol_decoder.pos_embed"] = _t(np.asarray(vol["pos_embed"]).transpose(0, 4, 1, 2, 3))
    if "layers" in vol:
        # one block size: a scanned stack with a leading layer axis
        stack = vol["layers"]["block"]
        blocks = [_layer(stack, i) for i in range(np.asarray(stack["norm1"]["scale"]).shape[0])]
    else:
        # block sizes cycling over n_groups (volume.py:213-222): layer0 … layer{L-1}
        n = sum(k.startswith("layer") and k[5:].isdigit() for k in vol)
        blocks = [vol[f"layer{i}"] for i in range(n)]
    for i, blk in enumerate(blocks):
        key = f"vol_decoder.layers.{i}."
        for nm in ("norm1", "norm2", "norm3"):
            _layernorm(sd, key + nm, blk[nm])
        _mha(sd, key + "cross_attn", blk["cross_attn"])
        _linear(sd, key + "mlp.0", blk["mlp"]["fc1"])
        _linear(sd, key + "mlp.3", blk["mlp"]["fc2"])
        # [kd, kh, kw, in, out] → [out, in, kd, kh, kw]
        sd[key + "cnn.weight"] = _t(np.asarray(blk["cnn"]["kernel"]).transpose(4, 3, 0, 1, 2))
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


# ------------------------------------------- reference Lightning checkpoints

def network_keys(num_layers: int = 12, encoder_depth: int = 12) -> List[str]:
    """The reference `Network`'s parameter names that the JAX package's
    `convert_network_state_dict` reads (besides the optional `view_embed`),
    which are the port's `LaRaNet` state-dict keys."""
    wb = (".weight", ".bias")
    vit = "img_encoder.model."
    keys = [vit + "cls_token", vit + "pos_embed"]
    keys += [vit + n + s for n in ("patch_embed.proj", "norm") for s in wb]
    keys += [f"{vit}blocks.{i}.{n}{s}" for i in range(encoder_depth)
             for n in ("norm1", "attn.qkv", "attn.proj", "norm2", "mlp.fc1", "mlp.fc2")
             for s in wb]
    keys += ["dir_norm." + n + s for n in ("norm", "mlp.1") for s in wb]
    mha = ("q_proj_weight", "k_proj_weight", "v_proj_weight", "out_proj.weight")
    keys.append("vol_decoder.pos_embed")
    for i in range(num_layers):
        pre = f"vol_decoder.layers.{i}."
        keys += [pre + n + s for n in ("norm1", "norm2", "norm3", "mlp.0", "mlp.3") for s in wb]
        keys += [pre + "cross_attn." + n for n in mha] + [pre + "cnn.weight"]
    keys += ["vol_decoder." + n + s for n in ("norm", "deconv") for s in wb]
    keys += ["decoder." + n + s for n in ("mlp_coarse.0", "mlp_coarse.2", "mlp_coarse.4",
                                          "norm", "mlp_fine.0", "mlp_fine.2") for s in wb]
    keys += ["decoder.cross_att." + n for n in mha]
    return keys


class StubbedObject:
    """Stands in for an object of a class the checkpoint loader does not
    rebuild (Lightning's, OmegaConf's, ...): it keeps the arguments and the
    state it was given and is never used."""

    stub_of = ""

    def __init__(self, *args, **kwargs):
        self.args, self.kwargs = args, kwargs

    def __setstate__(self, state):
        self.state = state

    def __setitem__(self, key, value):
        self.__dict__.setdefault("items", {})[key] = value

    def append(self, value):
        self.__dict__.setdefault("values", []).append(value)

    def extend(self, values):
        self.__dict__.setdefault("values", []).extend(values)


def _rebuilds(module: str, name: str) -> bool:
    """The globals a checkpoint's pickle may name that the loader rebuilds:
    tensors, NumPy arrays and plain containers."""
    if module in ("torch._utils", "torch._tensor") and name.startswith("_rebuild"):
        return True
    if module == "torch":
        return name in ("Size", "device", "Tensor") or isinstance(getattr(torch, name, None),
                                                                 torch.dtype)
    if module in ("numpy.core.multiarray", "numpy._core.multiarray"):
        return name in ("_reconstruct", "scalar")
    return (module, name) in {
        ("collections", "OrderedDict"), ("collections", "defaultdict"),
        ("torch.nn.parameter", "Parameter"), ("numpy", "ndarray"), ("numpy", "dtype"),
        ("copyreg", "_reconstructor"), ("builtins", "object"), ("builtins", "set"),
        ("builtins", "frozenset"), ("builtins", "slice"), ("builtins", "complex"),
        ("builtins", "bytearray"), ("builtins", "list"), ("builtins", "dict"),
        ("builtins", "tuple")} or (module.startswith("numpy") and name.endswith("DType"))


class _StubbingUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if _rebuilds(module, name):
            return super().find_class(module, name)
        return type(name, (StubbedObject,), {"stub_of": f"{module}.{name}"})


def _stubbing_pickle_module():
    mod = types.ModuleType("lara_stubbing_pickle")
    mod.Unpickler = _StubbingUnpickler
    mod.load = lambda f, **kw: _StubbingUnpickler(f, **kw).load()
    return mod


def read_lightning_payload(path: str) -> Any:
    """torch.load of a checkpoint whose pickle may name classes this machine
    lacks: tensors, arrays and containers are rebuilt, every other class is
    a `StubbedObject` (and nothing the file names is called)."""
    return torch.load(path, map_location="cpu", weights_only=False,
                      pickle_module=_stubbing_pickle_module())


def network_state_dict(sd: Mapping, num_layers: int = 12, encoder_depth: int = 12
                       ) -> Tuple[Dict[str, torch.Tensor], List[str]]:
    """A reference `Network` state dict (keys with or without `net.`) → the
    port's state dict (f32) and the sorted keys dropped: what is not the
    network's (keys without `net.` where others have it) and the timm ViT's
    keys the network never reads (a classifier head, blocks past
    `encoder_depth`, ...), which `lara_tpu/models/convert.py:
    convert_timm_state_dict` leaves unread. Any other key, or a missing
    one, raises."""
    want = set(network_keys(num_layers, encoder_depth)) | {"view_embed"}
    has_net = any(k.startswith("net.") for k in sd)
    out, dropped, unknown = {}, [], []
    for key, value in sd.items():
        name = key[4:] if key.startswith("net.") else key
        if name in want and (key.startswith("net.") or not has_net):
            out[name] = torch.as_tensor(value).detach().to("cpu", torch.float32).contiguous()
        elif (has_net and not key.startswith("net.")) or name.startswith("img_encoder.model."):
            dropped.append(key)
        else:
            unknown.append(key)
    if unknown:
        raise ValueError(f"{len(unknown)} checkpoint keys match no parameter of the network "
                         f"(num_layers={num_layers}, encoder_depth={encoder_depth}): "
                         f"{sorted(unknown)[:8]}")
    missing = sorted(want - {"view_embed"} - set(out))
    if missing:
        raise KeyError(f"{len(missing)} parameters of the network are not in the checkpoint "
                       f"(num_layers={num_layers}, encoder_depth={encoder_depth}): "
                       f"{missing[:8]}")
    return out, sorted(dropped)


def load_lightning_checkpoint(path: str, net: Optional[torch.nn.Module] = None,
                              num_layers: int = 12, encoder_depth: int = 12
                              ) -> Tuple[Dict[str, torch.Tensor], List[str]]:
    """A reference Lightning `.ckpt` (its `state_dict`) or a bare state-dict
    file → (the port's state dict, the dropped keys); loaded into `net`
    with strict=True when one is given (its missing or unexpected keys
    raise there)."""
    obj = read_lightning_payload(path)
    sd = obj["state_dict"] if isinstance(obj, Mapping) and "state_dict" in obj else obj
    if not isinstance(sd, Mapping):
        raise ValueError(f"{path}: no state dict in the checkpoint (a {type(sd).__name__})")
    out, dropped = network_state_dict(sd, num_layers, encoder_depth)
    if net is not None:
        net.load_state_dict(out, strict=True)
    return out, dropped
