"""The port's config mirrors `lara_tpu.config`: same dataclasses, fields,
defaults and YAML merge results."""

import dataclasses

import pytest
import torch

import lara_tpu.config as jcfg
import lara_tpu_torch.config as tcfg

CLASSES = ["Config", "ModelConfig", "RenderConfig", "DatasetConfig",
           "TrainConfig", "LoggerConfig", "InferConfig"]


@pytest.mark.parametrize("name", CLASSES)
def test_same_fields_and_defaults(name):
    ours, theirs = getattr(tcfg, name), getattr(jcfg, name)
    assert [f.name for f in dataclasses.fields(ours)] == \
        [f.name for f in dataclasses.fields(theirs)]
    assert dataclasses.asdict(ours()) == dataclasses.asdict(theirs())


@pytest.mark.parametrize("paths,overrides", [
    (("configs/base.yaml",), []),
    (("configs/base.yaml", "configs/synthetic.yaml"), []),
    (("configs/base.yaml", "configs/synthetic.yaml"),
     ["render.eval_tile_budget=256", "model.n_groups=[8]", "exp_name=x"]),
])
def test_load_config_equal(paths, overrides):
    ours = tcfg.load_config(*paths, overrides=overrides)
    theirs = jcfg.load_config(*paths, overrides=overrides)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)


def _tiny_net(section: str, **fields):
    """A CPU LaRaNet of tests/test_model.py:tiny_config with `fields` set
    in its config section `section`."""
    from lara_tpu_torch.models import LaRaNet
    from tests.test_model import tiny_config

    tiny = tcfg.config_from_dict(dataclasses.asdict(tiny_config()))
    part = dataclasses.replace(getattr(tiny, section), **fields)
    return LaRaNet(dataclasses.replace(tiny, **{section: part}), dtype=torch.float32,
                   device="cpu")


@pytest.mark.parametrize("override", ["render.bin_mode=count", "render.pack_mode=fused"])
def test_binning_modes_accepted(override):
    """The binning's modes load in both packages with equal results and
    reach the raster config of a LaRaNet (tiled.py:bin_view reads them)."""
    ours = tcfg.load_config("configs/base.yaml", overrides=[override])
    theirs = jcfg.load_config("configs/base.yaml", overrides=[override])
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    name, value = override.split(".")[1].split("=")
    assert getattr(ours.render, name) == value

    rcfg = _tiny_net("render", **{name: value})._render_cfg(64, 64, train=True)
    assert (rcfg.bin_mode, rcfg.pack_mode) == (
        {"bin_mode": (value, "gather"), "pack_mode": ("sort", value)}[name])


@pytest.mark.parametrize("override", ["render.pallas_stash_carries=false",
                                      "model.flash_attn=true",
                                      "model.remat_policy=dots"])
def test_training_knobs_accepted(override):
    """Each of these selects a kernel or mode of the training path (the
    replay backward, flash attention, the dots remat policy): it loads in
    both packages and reaches the module that reads it."""
    ours = tcfg.load_config("configs/base.yaml", overrides=[override])
    theirs = jcfg.load_config("configs/base.yaml", overrides=[override])
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)

    section, assign = override.split(".")
    name, value = assign.split("=")
    value = {"true": True, "false": False}.get(value, value)
    net = _tiny_net(section, **{name: value})
    vit, rcfg = net.img_encoder.model, net._render_cfg(64, 64, train=True)
    assert all(blk.attn.use_flash == (override == "model.flash_attn=true")
               for blk in vit.blocks)
    assert rcfg.stash_carries == (override != "render.pallas_stash_carries=false")
    policy = "dots" if override == "model.remat_policy=dots" else "full"
    assert vit.remat_policy == net.vol_decoder.remat_policy == policy
