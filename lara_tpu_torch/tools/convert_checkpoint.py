"""Convert the reference's Lightning checkpoint (the released
`epoch=29.ckpt`) into a checkpoint of the port, the counterpart of
`tools/convert_checkpoint.py`:

    python -m lara_tpu_torch.tools.convert_checkpoint CKPT OUT_DIR [--layers 12]
        [--encoder-depth 12] [config.yaml ...] [key.sub=value ...]

CKPT is a Lightning `.ckpt` or a bare state-dict file; its pickle may name
classes this machine lacks (they are stubbed, `models/convert.py:
read_lightning_payload`). The network is built on the CPU from
`configs/base.yaml`, the given configs and overrides (`--layers` and
`--encoder-depth` set `model.num_layers` / `model.encoder_depth`), and the
converted parameters are loaded into it with strict=True. Writes
`OUT_DIR/step_000000000.pt`, which `train/checkpoint.py:restore_params`
reads (evaluate with `infer.ckpt_path=OUT_DIR`), and
`OUT_DIR/parity_report.json`: shape, l2 and absmax of every tensor.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path
from typing import List, Optional

import torch

from lara_tpu_torch.config import load_config, parse_cli
from lara_tpu_torch.models import LaRaNet
from lara_tpu_torch.models.convert import load_lightning_checkpoint
from lara_tpu_torch.train.checkpoint import checkpoint_path

CONFIGS = Path(__file__).resolve().parents[2] / "configs"


def main(argv: Optional[List[str]] = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("ckpt")
    p.add_argument("out_dir")
    p.add_argument("--layers", type=int, default=None)
    p.add_argument("--encoder-depth", type=int, default=None)
    p.add_argument("config", nargs="*", help="config files and key=value overrides")
    args = p.parse_args(sys.argv[1:] if argv is None else argv)

    paths, overrides = parse_cli(args.config)
    if args.layers is not None:
        overrides.append(f"model.num_layers={args.layers}")
    if args.encoder_depth is not None:
        overrides.append(f"model.encoder_depth={args.encoder_depth}")
    cfg = load_config(str(CONFIGS / "base.yaml"), *paths, overrides=overrides)
    net = LaRaNet(cfg, dtype=torch.float32, device="cpu")
    sd, dropped = load_lightning_checkpoint(args.ckpt, net, num_layers=cfg.model.num_layers,
                                            encoder_depth=cfg.model.encoder_depth)

    report = {k: {"shape": list(v.shape), "l2": float(torch.linalg.vector_norm(v.double())),
                  "absmax": float(v.abs().max())} for k, v in sd.items()}
    os.makedirs(args.out_dir, exist_ok=True)
    path = checkpoint_path(args.out_dir, 0)
    torch.save({"params": sd}, path)
    with open(os.path.join(args.out_dir, "parity_report.json"), "w") as f:
        json.dump(report, f, indent=1, sort_keys=True)
    print(f"converted {len(sd)} tensors -> {path}; dropped {len(dropped)} keys the network "
          f"does not read: {dropped}")
    return {"path": path, "dropped": dropped, "report": report}


if __name__ == "__main__":
    main()
