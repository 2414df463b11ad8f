"""What the benchmark takes from the program under test, `lara_tpu_torch`:
its configuration, the network, its training step and its serving forward,
and the places where the traced run opens its spans. Nothing else of the
benchmark imports the program.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict

import torch

SPANS = ("network", "network.vit", "network.modln", "network.feat_vol", "network.volume",
         "network.coarse_decoder", "network.fine_stage", "raster.render", "raster.rerender",
         "raster.blend", "loss", "backward", "optimizer", "allreduce", "step")


def config(entry: Dict):
    """The program's Config with the configuration file's keys."""
    from lara_tpu_torch.config import Config
    base = Config()
    model = dict(entry["model"])
    model["n_groups"] = tuple(model["n_groups"])
    return dataclasses.replace(
        base, n_views=entry["n_views"],
        model=dataclasses.replace(base.model, **model),
        render=dataclasses.replace(base.render, **entry["render"]),
        train=dataclasses.replace(base.train, **entry["train"]),
        infer=dataclasses.replace(base.infer, **entry["infer"]))


def network(cfg, weights: Dict[str, torch.Tensor], device):
    """The program's LaRaNet in bf16 autocast holding `weights`."""
    from lara_tpu_torch.models import LaRaNet
    net = LaRaNet(cfg, dtype=torch.bfloat16, device=device)
    net.load_state_dict(weights, strict=True)
    return net


def train_step(net, cfg, start_step: int, max_iters: int):
    """(the program's fine training micro-step, its TrainState)."""
    from lara_tpu_torch.train.state import TrainState
    from lara_tpu_torch.train.step import make_train_step
    state = TrainState(net, cfg.train, max_iters=max_iters, step=start_step)
    return make_train_step(net, state, True, cfg.train.grad_accum), state


def forward(net, cfg):
    """The program's serving forward (coarse + fine, eval budgets), with
    its surfels returned as `render_pkg`."""
    from lara_tpu_torch.train.step import make_forward
    return make_forward(net, with_fine=True, return_buffer=True,
                        render_scale=cfg.infer.render_img_scale)


def served(out: Dict) -> Dict:
    """A served request's outputs in the comparison's terms."""
    centers, sh, opacity, scaling, rotation = out["render_pkg"]["coarse"]
    fine_sh, fine_op = out["render_pkg"]["fine"][1], out["render_pkg"]["fine"][2]
    return {"surfels": (centers, sh, opacity, scaling, rotation), "sh_fine": fine_sh,
            "selected": fine_op[..., 0] > -9999.0,
            "maps": {k: out[k] for k in MAPS}}


MAPS = ("image", "depth", "rend_normal", "acc_map",
        "image_fine", "depth_fine", "rend_normal_fine", "acc_map_fine")


def blend_config(rcfg):
    """The reference's raster configuration of a program blend call."""
    from benchmark.reference.raster import RasterConfig
    return RasterConfig(height=rcfg.height, width=rcfg.width, tile=rcfg.tile, dup=rcfg.dup,
                        tile_budget=rcfg.tile_budget, visible_budget=rcfg.visible_budget,
                        chunk=rcfg.pallas_chunk, sh_degree=rcfg.sh_degree)


class Spans:
    """Opens a named `record_function` span around each call into a layer
    of the program, and keeps the first `keep_blend` blend calls' inputs
    (their entries, counts, scalars and raster configuration) for the
    blend kernels' work. `remove()` puts everything back."""

    def __init__(self, net, state=None, keep_blend: int = 0):
        from lara_tpu_torch.models import lara
        from lara_tpu_torch.ops.rasterizer import cuda_blend
        from lara_tpu_torch.train import state as state_mod, step as step_mod
        self.blend_calls, self.keep_blend = [], keep_blend
        self._undo = []
        rf = torch.autograd.profiler.record_function

        def wrap(obj, attr, name):
            fn = getattr(obj, attr)
            # a method of the class: removing the instance's wrapper restores it
            own = attr not in vars(obj)

            @functools.wraps(fn)
            def spanned(*a, **k):
                with rf(name):
                    return fn(*a, **k)
            self._undo.append((obj, attr, fn, own))
            setattr(obj, attr, spanned)

        def blend(fn):
            @functools.wraps(fn)
            def spanned(entries, counts, scalars, cfg):
                if len(self.blend_calls) < self.keep_blend:
                    self.blend_calls.append((entries.detach(), counts, scalars, cfg))
                with rf("raster.blend"):
                    return fn(entries, counts, scalars, cfg)
            return spanned

        for obj, attr, name in ((net, "forward", "network"),
                                (net.img_encoder, "forward", "network.vit"),
                                (net.dir_norm, "forward", "network.modln"),
                                (net, "build_feat_vol", "network.feat_vol"),
                                (net.vol_decoder, "forward", "network.volume"),
                                (net.decoder, "forward_coarse", "network.coarse_decoder"),
                                (net, "_fine_stage", "network.fine_stage")):
            wrap(obj, attr, name)
        wrap(lara, "render_view", "raster.render")
        wrap(lara, "render_view_rebind", "raster.rerender")
        wrap(step_mod, "compute_losses", "loss")
        # the host's side of the backward (the kernels it launches belong to
        # their forward ops' spans)
        wrap(torch.autograd, "backward", "backward")
        wrap(state_mod, "all_reduce_grads_", "allreduce")
        if state is not None:
            wrap(state, "apply_gradients", "optimizer")
        fn = cuda_blend.blend_tiles
        self._undo.append((cuda_blend, "blend_tiles", fn, False))
        cuda_blend.blend_tiles = blend(fn)

    def remove(self) -> None:
        for obj, attr, fn, own in reversed(self._undo):
            if own:
                delattr(obj, attr)
            else:
                setattr(obj, attr, fn)
        self._undo = []
