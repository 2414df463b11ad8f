"""Layered YAML configuration: the same frozen dataclasses, defaults and
merge rules as `lara_tpu/config.py`, so one YAML file configures both
packages.

The reference merges `configs/base.yaml ← [infer.yaml] ← CLI dotlist`
(train_lightning.py:98-101, evaluation.py:180-184) with `${key}`
interpolation (configs/base.yaml:35,47). The YAML is read by this module's
own reader (`parse_yaml`) of the subset that `configs/*.yaml` use, with
PyYAML's scalar rules, so the package needs no PyYAML.

Usage:
    cfg = load_config("configs/base.yaml", overrides=["train.lr=1e-4"])
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Mirrors configs/base.yaml `model:` (lines 6-27)."""
    encoder_backbone: str = "vit_base_patch16_224.dino"
    encoder_dim: int = 768
    encoder_depth: int = 12
    encoder_heads: int = 12
    patch_size: int = 16
    encoder_pretrained_path: Optional[str] = None  # timm state-dict file (optional)
    n_groups: Tuple[int, ...] = (16,)
    n_offset_groups: int = 32
    K: int = 2
    sh_degree: int = 1
    num_layers: int = 12
    num_heads: int = 16
    view_embed_dim: int = 32
    embedding_dim: int = 256
    vol_feat_reso: int = 16
    vol_embedding_reso: int = 32
    vol_embedding_out_dim: int = 80
    ckpt_path: Optional[str] = None
    scene_size: float = 0.5
    # Training-memory knobs. `remat` checkpoints each ViT block and each
    # volume-transformer layer (torch.utils.checkpoint) when gradients are
    # on, under remat_policy "full" (keep the inputs) or "dots" (also keep
    # the dense layers' outputs; models/remat.py). flash_attn runs the
    # ViT's self-attention through the flash kernels (ops/flash.py).
    # remat_views / remat_views_save exist for the TPU's lane-padded layout
    # (lara_tpu/models/lara.py:243-258): the port keeps every render's
    # residuals (the flagship B=3 step fits an H100, PERF.md) and accepts
    # them only so the same YAML loads.
    remat: bool = True
    remat_policy: str = "full"
    flash_attn: bool = False
    remat_views: bool = True
    remat_views_save: str = "bin,packed,entries,stash"
    # Static surfel budget for the fine stage (replaces the dynamic boolean
    # masking of lightning/network.py:465,479,504-511): the fine pass
    # refines/re-renders the top-M surfels by opacity.
    fine_budget: int = 131072


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Rasterizer knobs (no reference equivalent — CUDA had them compiled in).
    backend "auto" → the CUDA blend kernel (the port's one backend).

    `pallas_chunk` is the number of entries the blend kernels stage per
    step. `pallas_stash_carries`: training renders keep the forward's
    per-chunk carries for the backward (True), or the backward kernel
    replays each tile's forward walk and keeps nothing between the passes
    (False). `pallas_tiles_per_step` and `pallas_cumsum` are TPU kernel
    knobs: accepted so the same YAML loads, unused here."""
    backend: str = "auto"
    tile: int = 16
    dup: int = 3
    tile_budget: int = 128
    tile_chunk: int = 32
    eval_tile_budget: int = 512
    # nearest-surfel compaction budget before dup-expansion (see
    # RasterizeConfig.visible_budget); 0 = keep all candidates.
    visible_budget: int = 131072
    eval_visible_budget: int = 262144
    # blend kernel: entries staged per step (clamped to the tile budget)
    pallas_chunk: int = 64
    pallas_tiles_per_step: int = 4      # TPU only, unused
    # tile-window construction: "sort" or "count" (RasterizeConfig.bin_mode)
    bin_mode: str = "sort"
    # depth-compaction data movement: "gather" or "fused"
    # (RasterizeConfig.pack_mode)
    pack_mode: str = "gather"
    pallas_stash_carries: bool = True   # False: the replay backward
    pallas_cumsum: str = "shift"        # TPU only, unused


@dataclasses.dataclass(frozen=True)
class DatasetConfig:
    """Mirrors configs/base.yaml `train_dataset:`/`test_dataset:` (29-49)."""
    dataset_name: str = "gobjeverse"
    data_root: str = "dataset/gobjaverse/gobjaverse.h5"
    split: str = "train"
    img_size: Tuple[int, int] = (512, 512)
    n_group: int = 4
    n_scenes: int = 3000000
    load_normal: bool = True
    batch_size: int = 3
    num_workers: int = 4


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Mirrors configs/base.yaml `train:` (51-64)."""
    batch_size: int = 3
    lr: float = 4e-4
    beta1: float = 0.9
    beta2: float = 0.95
    weight_decay: float = 0.05
    warmup_iters: int = 1000
    n_epoch: int = 30
    limit_train_batches: float = 0.2
    limit_val_batches: float = 0.02
    check_val_every_n_epoch: int = 1
    start_fine: int = 5000
    use_rand_views: bool = False
    grad_accum: int = 2          # train_lightning.py:73
    grad_clip: float = 0.5       # train_lightning.py:74
    ckpt_every_n_epoch: int = 5  # train_lightning.py:58-64
    vis_every_n_steps: int = 3000
    seed: int = 0
    # NaN sanitizer (torch.autograd.set_detect_anomaly(True),
    # train_lightning.py:30). Off by default — it forces sync dispatch.
    detect_anomaly: bool = False
    # tensor-parallel width for the volume transformer's group axis
    # (SURVEY.md §5.7); devices are arranged as (dp = n/tp, tp). 1 = pure
    # data parallelism (the reference's DDP, train_lightning.py:68-72).
    tp: int = 1


@dataclasses.dataclass(frozen=True)
class LoggerConfig:
    name: str = "tensorboard"
    dir: str = "logs/default"


@dataclasses.dataclass(frozen=True)
class InferConfig:
    """Mirrors configs/infer.yaml `infer:` options."""
    ckpt_path: Optional[str] = None
    save_folder: str = "outputs/"
    eval_novel_view_only: bool = True
    eval_depth: Tuple[float, ...] = ()
    video_frames: int = 0
    save_mesh: bool = False
    mesh_video: bool = False
    metric_path: str = "outputs/metrics"
    render_img_scale: float = 1.0
    # Hard-fail when LPIPS weights are missing/corrupt instead of skipping
    # the metric (the reference always hard-fails, evaluation.py:48-49).
    require_lpips: bool = False


@dataclasses.dataclass(frozen=True)
class Config:
    exp_name: str = "lara_tpu/dev"
    n_views: int = 4
    model: ModelConfig = ModelConfig()
    render: RenderConfig = RenderConfig()
    train_dataset: DatasetConfig = DatasetConfig()
    test_dataset: DatasetConfig = dataclasses.field(
        default_factory=lambda: DatasetConfig(split="test"))
    train: TrainConfig = TrainConfig()
    logger: LoggerConfig = LoggerConfig()
    infer: InferConfig = InferConfig()
    infer_dataset: DatasetConfig = dataclasses.field(
        default_factory=lambda: DatasetConfig(split="test", num_workers=0))


_INTERP = re.compile(r"^\$\{([a-zA-Z0-9_.]+)\}$")
_INTERP_EMBED = re.compile(r"\$\{([a-zA-Z0-9_.]+)\}")


def _deep_merge(base: Dict, over: Dict) -> Dict:
    out = dict(base)
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def _resolve_interp(node: Any, root: Dict) -> Any:
    if isinstance(node, dict):
        return {k: _resolve_interp(v, root) for k, v in node.items()}
    if isinstance(node, list):
        return [_resolve_interp(v, root) for v in node]
    if isinstance(node, str):
        def lookup(key: str) -> Any:
            cur: Any = root
            for part in key.split("."):
                cur = cur[part]
            return cur

        m = _INTERP.match(node)
        if m:  # whole-string reference keeps the referenced type
            return lookup(m.group(1))
        # embedded references interpolate as strings ("logs/${exp_name}")
        return _INTERP_EMBED.sub(lambda mm: str(lookup(mm.group(1))), node)
    return node


class YamlSubsetError(ValueError):
    """Text outside the YAML subset that `parse_yaml` reads."""


# PyYAML's implicit resolvers (YAML 1.1, yaml/resolver.py) for the scalars
# of the subset; sexagesimal numbers and timestamps are outside it
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                   r"|on|On|ON|off|Off|OFF)$")
_INT = re.compile(r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)"
                  r"|[-+]?0x[0-9a-fA-F_]+)$")
_FLOAT = re.compile(r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$")
_UNSUPPORTED = re.compile(r"^[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?$"
                          r"|^[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}")
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n",
            "v": "\v", "f": "\f", "r": "\r", "e": "\x1b", " ": " ", '"': '"',
            "/": "/", "\\": "\\"}


def _plain_scalar(s: str, where: str) -> Any:
    if _UNSUPPORTED.match(s):
        raise YamlSubsetError(f"{where}: sexagesimal or timestamp scalar {s!r}")
    if _NULL.match(s):
        return None
    if _BOOL.match(s):
        return s.lower() in ("yes", "true", "on")
    if _INT.match(s):
        t = s.replace("_", "")
        sign, t = (-1, t[1:]) if t[0] == "-" else (1, t.lstrip("+"))
        if t.startswith("0b"):
            return sign * int(t[2:], 2)
        if t.startswith("0x"):
            return sign * int(t[2:], 16)
        return sign * int(t, 8 if len(t) > 1 and t[0] == "0" else 10)
    if _FLOAT.match(s):
        t = s.replace("_", "").lower()
        if t.endswith(".inf"):
            return -float("inf") if t[0] == "-" else float("inf")
        return float("nan") if t == ".nan" else float(t)
    if s[0] in "&*!|>%@`{}[]'\"," or s[:2] in ("- ", "? ") or s in ("-", "?") \
            or ": " in s or s.endswith(":") or " #" in s:
        raise YamlSubsetError(f"{where}: not a scalar of the subset: {s!r}")
    return s


def _quoted(text: str, i: int, where: str):
    """The quoted scalar starting at text[i]; returns (value, end index)."""
    q, out, i = text[i], [], i + 1
    while i < len(text):
        c = text[i]
        if c == q:
            if q == "'" and text[i + 1:i + 2] == "'":
                out.append("'")
                i += 2
                continue
            return "".join(out), i + 1
        if q == '"' and c == "\\":
            e = text[i + 1:i + 2]
            if e == "x" and re.fullmatch(r"[0-9a-fA-F]{2}", text[i + 2:i + 4]):
                out.append(chr(int(text[i + 2:i + 4], 16)))
                i += 4
                continue
            if e not in _ESCAPES:
                raise YamlSubsetError(f"{where}: escape \\{e} outside the subset")
            out.append(_ESCAPES[e])
            i += 2
            continue
        out.append(c)
        i += 1
    raise YamlSubsetError(f"{where}: unterminated {q}-quoted string")


def _flow_list(text: str, i: int, where: str):
    """The flow list `[a, b, ...]` starting at text[i]; returns (list, end)."""
    items, i, expect_item = [], i + 1, True
    while True:
        while i < len(text) and text[i] == " ":
            i += 1
        if i >= len(text):
            raise YamlSubsetError(f"{where}: unterminated flow list")
        c = text[i]
        if c == "]":
            return items, i + 1
        if c == ",":
            if expect_item:
                raise YamlSubsetError(f"{where}: empty flow list item")
            expect_item, i = True, i + 1
            continue
        if not expect_item:
            raise YamlSubsetError(f"{where}: expected ',' or ']' in a flow list")
        if c == "[":
            item, i = _flow_list(text, i, where)
        elif c in "'\"":
            item, i = _quoted(text, i, where)
        else:
            j = i
            while j < len(text) and text[j] not in ",[]{}":
                j += 1
            raw = text[i:j].rstrip()
            if not raw or ": " in raw or raw.endswith(":") or raw[0] in "&*!|>%@`#{":
                raise YamlSubsetError(f"{where}: not a flow item of the subset: {raw!r}")
            item, i = _plain_scalar(raw, where), j
        items.append(item)
        expect_item = False


def _value(text: str, where: str) -> Any:
    """One scalar or flow list, with an optional trailing comment."""
    text = text.strip(" ")
    if not text or text.startswith("#"):
        return None
    if text[0] in "'\"[":
        val, end = (_flow_list if text[0] == "[" else _quoted)(text, 0, where)
        rest = text[end:].strip(" ")
        if rest and not rest.startswith("#"):
            raise YamlSubsetError(f"{where}: text after a {text[0]}...: {rest!r}")
        if rest and end < len(text) and text[end] != " ":
            raise YamlSubsetError(f"{where}: a comment needs a space before '#'")
        return val
    return _plain_scalar(re.split(r"\s#", text, maxsplit=1)[0].rstrip(" "), where)


def parse_yaml(text: str, source: str = "<string>") -> Any:
    """Read the YAML subset of `configs/*.yaml`: nested block maps, scalars
    with PyYAML's (YAML 1.1) resolution rules, quoted strings, flow lists
    and comments. Returns what `yaml.safe_load` returns for such text; any
    construct outside the subset raises YamlSubsetError naming
    `source:line`, and nothing unrecognised is read as a string."""
    lines = []
    for n, raw in enumerate(text.splitlines(), 1):
        where = f"{source}:{n}"
        body = raw.rstrip(" \r")
        stripped = body.lstrip(" ")
        if not stripped or stripped.startswith("#"):
            continue
        if "\t" in body[:len(body) - len(stripped) + 1]:
            raise YamlSubsetError(f"{where}: tab in the indentation")
        if stripped in ("---", "...") or stripped.startswith(("--- ", "%")):
            raise YamlSubsetError(f"{where}: document markers are outside the subset")
        lines.append((len(body) - len(stripped), stripped, where))
    if not lines:
        return None
    if len(lines) == 1 and lines[0][0] == 0 and not re.match(r"[^'\"\[].*?:( |$)",
                                                             lines[0][1]):
        return _value(lines[0][1], lines[0][2])

    def block(k: int, indent: int):
        out: Dict = {}
        while k < len(lines) and lines[k][0] >= indent:
            ind, body, where = lines[k]
            if ind != indent:
                raise YamlSubsetError(f"{where}: unexpected indentation")
            m = re.match(r"([^'\"\[\]{}#&*!|>%@`,?-][^:#]*?|-[^ :#][^:#]*?):( |$)", body)
            if not m:
                raise YamlSubsetError(f"{where}: expected 'key: value'")
            key = _plain_scalar(m.group(1).rstrip(" "), where)
            rest = body[m.end():]
            if rest.strip(" ") and not rest.strip(" ").startswith("#"):
                out[key] = _value(rest, where)
                k += 1
            elif k + 1 < len(lines) and lines[k + 1][0] > indent:
                out[key], k = block(k + 1, lines[k + 1][0])
            else:
                out[key] = None
                k += 1
        return out, k

    out, k = block(0, lines[0][0])
    if k != len(lines):
        raise YamlSubsetError(f"{lines[k][2]}: unexpected indentation")
    return out


def _parse_value(s: str) -> Any:
    """A dotlist value, read as `yaml.safe_load` reads a scalar or flow list."""
    return _value(s, f"override value {s!r}")


def _apply_dotlist(d: Dict, overrides: List[str]) -> Dict:
    for item in overrides:
        if "=" not in item:
            raise ValueError(f"override must be key=value, got {item!r}")
        key, val = item.split("=", 1)
        cur = d
        parts = key.split(".")
        for p in parts[:-1]:
            cur = cur.setdefault(p, {})
        cur[parts[-1]] = _parse_value(val)
    return d


def _build(dc_type, data: Dict):
    fields = {f.name: f for f in dataclasses.fields(dc_type)}
    kwargs = {}
    for k, v in data.items():
        if k not in fields:
            continue  # tolerate unknown keys (reference cfg.get style)
        ft = fields[k].type
        f_default = fields[k].default
        if dataclasses.is_dataclass(f_default) and isinstance(v, dict):
            kwargs[k] = _build(type(f_default), v)
        elif isinstance(fields[k].default_factory(), tuple) if fields[k].default_factory is not dataclasses.MISSING else False:  # pragma: no cover
            kwargs[k] = tuple(v)
        elif fields[k].default_factory is not dataclasses.MISSING and isinstance(v, dict):
            kwargs[k] = _build(type(fields[k].default_factory()), v)
        elif isinstance(v, list):
            kwargs[k] = tuple(v)
        else:
            kwargs[k] = v
    return dc_type(**kwargs)


def config_from_dict(data: Dict) -> Config:
    data = _resolve_interp(data, data)
    return _build(Config, data)


def parse_cli(argv: List[str]) -> Tuple[List[str], List[str]]:
    """Split CLI args into (yaml paths, key=value dotlist overrides) — the
    argument convention shared by train.py / evaluate.py / eval_all.py
    (reference: OmegaConf.from_cli, train_lightning.py:98-101)."""
    paths, overrides = [], []
    for a in argv:
        if a.endswith((".yaml", ".yml")):
            paths.append(a)
        elif "=" in a:
            overrides.append(a)
        else:
            raise SystemExit(f"unrecognized argument: {a!r}")
    return paths, overrides


def load_config(*paths: str, overrides: Optional[List[str]] = None) -> Config:
    """Merge YAML files left-to-right, then apply `key.sub=value` overrides."""
    merged: Dict = {}
    for path in paths:
        with open(path) as f:
            merged = _deep_merge(merged, parse_yaml(f.read(), path) or {})
    if overrides:
        merged = _apply_dotlist(merged, list(overrides))
    return config_from_dict(merged)
