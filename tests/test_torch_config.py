"""The port's config mirrors `lara_tpu.config`: same dataclasses, fields,
defaults and YAML merge results, read by the port's own YAML reader, which
gives what `yaml.safe_load` gives on every file of `configs/` and on
dotlist values, and raises (with file and line) outside its subset."""

import dataclasses
from pathlib import Path

import pytest
import torch
import yaml

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


CONFIGS = sorted(str(p.relative_to(Path(__file__).resolve().parents[1]))
                 for p in (Path(__file__).resolve().parents[1] / "configs").glob("*.yaml"))


def _same(a, b):
    """Equal values and types, recursively (True == 1 in Python)."""
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            _same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return isinstance(b, list) and len(a) == len(b) and all(map(_same, a, b))
    if isinstance(a, float) and a != a:
        return isinstance(b, float) and b != b
    return type(a) is type(b) and a == b


@pytest.mark.parametrize("path", CONFIGS)
def test_yaml_reader_matches_pyyaml(path):
    text = Path(path).read_text()
    assert _same(tcfg.parse_yaml(text, path), yaml.safe_load(text))


DOTLIST_VALUES = ["4.0e-4", "1e-4", "1.0e4", "-1.5e-3", ".5", "1.", "3", "-7", "+1",
                  "0", "017", "0x1F", "0b101", "1_000", "True", "false", "yes", "Off",
                  "null", "~", "", ".inf", "-.Inf", ".nan", "[16]", "[512, 512]",
                  "[]", "[[1, 2], [3]]", "[a, 'b c', \"d\"]", "logs/${exp_name}",
                  "${n_views}", "vit_base_patch16_224.dino", "'quoted # not a comment'",
                  "\"tab\\tx\"", "'it''s'", "a#b", "value # comment", "foo bar"]


@pytest.mark.parametrize("value", DOTLIST_VALUES)
def test_dotlist_value_matches_pyyaml(value):
    assert _same(tcfg._parse_value(value), yaml.safe_load(value))


@pytest.mark.parametrize("text,line", [
    ("a:\n  - 1\n", 2), ("a: 1\n\tb: 2\n", 2), ("a: foo\n  bar\n", 2),
    ("a:\n  b: 1\n   c: 2\n", 3), ("---\na: 1\n", 1), ("a: {b: 1}\n", 1),
    ("a: &x 1\n", 1), ("b: 1\na: *x\n", 2), ("a: !!str 1\n", 1), ("a: |\n  x\n", 1),
    ("a: [1, 2\n", 1), ("a: 'open\n", 1), ("a: 1:20\n", 1), ("a: 2001-12-14\n", 1),
    ("a: b: c\n", 1)])
def test_yaml_outside_subset_raises(text, line):
    with pytest.raises(tcfg.YamlSubsetError, match=f"^cfg.yaml:{line}: "):
        tcfg.parse_yaml(text, "cfg.yaml")


@pytest.mark.parametrize("path", [p for p in CONFIGS if not p.endswith("base.yaml")])
def test_load_config_every_file_equal(path):
    """Each config merged on base.yaml, as train.py does, in both packages."""
    ours = tcfg.load_config("configs/base.yaml", path, overrides=["train.lr=1e-4"])
    theirs = jcfg.load_config("configs/base.yaml", path, overrides=["train.lr=1e-4"])
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
