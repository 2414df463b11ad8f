"""The port's config mirrors `lara_tpu.config`: same dataclasses, fields,
defaults and YAML merge results."""

import dataclasses

import pytest

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


@pytest.mark.parametrize("override", ["render.bin_mode=count", "render.pack_mode=fused"])
def test_unported_render_modes_raise(override):
    with pytest.raises(ValueError):
        tcfg.load_config("configs/base.yaml", overrides=[override])
    name, value = override.split(".")[1].split("=")
    with pytest.raises(ValueError, match=name):
        tcfg.RenderConfig(**{name: value})
