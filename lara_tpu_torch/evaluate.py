"""Evaluation entry point of the port, the counterpart of `evaluate.py`
(evaluation.py:30-176 of the reference):

    python -m lara_tpu_torch.evaluate [config.yaml ...] [key.sub=value ...] [--device DEV]

Configs merge on top of `configs/base.yaml` and `configs/infer.yaml`;
trailing key=value pairs are dotlist overrides. The run is on the CUDA
device (`--device cuda`, the default) and raises without one; `--device
cpu` runs it on the CPU with the kernels' plain versions.

Per scene of `infer_dataset` (in order, the last batch kept): the forward
with the fine stage; PSNR, SSIM and, where their weights exist, LPIPS VGG /
Alex on one horizontal mosaic of the novel views; the depth metrics where
the batch has `tar_dep`; a gt / prediction panel `<save_folder>/<scene>.png`
for the first 100 scenes; the orbit video (`infer.video_frames` > 0) and
the TSDF mesh `<scene>.obj` (`infer.save_mesh`). The metrics go to
`<metric_path>/<dataset_name>.json` with the keys of `evaluate.py`.

Distributed evaluation (`python -m torch.distributed.run
--nproc_per_node=N -m lara_tpu_torch.evaluate ...`, or a process group the
caller made), as `evaluate.py:63-85` shards scenes over devices: with
`infer_dataset.batch_size` B, n_dp is the largest divisor of B up to the
world size, and rank r < n_dp takes scenes [r·B/n_dp, (r+1)·B/n_dp) of
each batch whose scene count divides by n_dp (rank 0 all of one that does
not); ranks from n_dp on take none. Each rank writes the panels, videos and
meshes of its scenes (the panel rule counts the scene's place in the whole
evaluation); rank 0 gathers every scene's metrics in scene order and
writes the JSON, the one-process JSON, which every rank returns.

What differs from `evaluate.py`: panels are PNG, not JPEG, and the video is
PNG frames where OpenCV is absent (no GIF); without `infer.ckpt_path` the
weights are the port's seeded init (`LaRaNet`'s generator, seed 0), not
the JAX package's `PRNGKey(0)` init.
"""

from __future__ import annotations

import json
import os
import sys
import warnings
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from lara_tpu_torch.config import load_config, parse_cli
from lara_tpu_torch.data import DataLoader, get_dataset
from lara_tpu_torch.data.loader import to_device
from lara_tpu_torch.eval.lpips import load_lpips
from lara_tpu_torch.eval.metrics import abs_error, acc_threshold, psnr, ssim
from lara_tpu_torch.eval.render_artifacts import extract_mesh, render_video
from lara_tpu_torch.eval.vis import write_png
from lara_tpu_torch.models import LaRaNet
from lara_tpu_torch.parallel.distributed import (gather_objects, is_main, process_group, rank,
                                                 resolve_device, world_size)
from lara_tpu_torch.train.__main__ import split_device
from lara_tpu_torch.train.checkpoint import restore_params
from lara_tpu_torch.train.step import make_forward

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def main(argv: Optional[List[str]] = None, dtype: torch.dtype = torch.bfloat16) -> dict:
    """Evaluate as the command line asks; returns the metrics dict that is
    written to the JSON (on every rank). `dtype` is the network's autocast
    type."""
    rest, device = split_device(list(sys.argv[1:] if argv is None else argv))
    device = resolve_device(device or "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("lara_tpu_torch.evaluate runs on the CUDA device, and none is "
                           "available; pass --device cpu to evaluate on the CPU")
    paths, overrides = parse_cli(rest)
    cfg = load_config(str(CONFIGS / "base.yaml"), str(CONFIGS / "infer.yaml"), *paths,
                      overrides=overrides)
    with process_group(device):
        return _evaluate(cfg, device, dtype)


def _evaluate(cfg, device: torch.device, dtype: torch.dtype, dataset=None) -> dict:
    """`main` after the command line: `dataset` (default: `infer_dataset`'s,
    built from `cfg`) is the dataset evaluated, e.g. an `MVGenDataset` with
    its generator injected."""
    ds_cfg = cfg.infer_dataset
    bs = ds_cfg.batch_size
    # scenes are independent: a batch of B scenes is split over n_dp ranks,
    # the largest divisor of B up to the world size (evaluate.py:63-72)
    n_dp = max(d for d in range(1, world_size() + 1) if bs % d == 0)
    r = rank()
    if dataset is None:
        dataset = get_dataset(ds_cfg.dataset_name)(ds_cfg)
    net = LaRaNet(cfg, dtype=dtype, device=device)
    if cfg.infer.ckpt_path:
        net.load_state_dict(restore_params(cfg.infer.ckpt_path), strict=True)
        if is_main():
            print(f"restored params from {cfg.infer.ckpt_path}")
    if n_dp > 1 and is_main():
        print(f"evaluating with dp={n_dp} over {n_dp} ranks")

    lpips_vgg_fn = _try_load_lpips("vgg", cfg.infer.require_lpips, device)
    lpips_alex_fn = _try_load_lpips("alex", cfg.infer.require_lpips, device)
    artifacts = cfg.infer.video_frames > 0 or cfg.infer.save_mesh
    fwd = make_forward(net, with_fine=True, return_buffer=artifacts,
                       render_scale=cfg.infer.render_img_scale)

    os.makedirs(cfg.infer.save_folder, exist_ok=True)
    os.makedirs(cfg.infer.metric_path, exist_ok=True)
    n_view = cfg.n_views
    rows = []      # one per scene of this rank: its global index, name, metrics
    loader = DataLoader(dataset, bs, shuffle=False, num_workers=ds_cfg.num_workers,
                        drop_last=False, rank=r, world_size=n_dp) if r < n_dp else []

    for i, batch in enumerate(loader):
        n_scenes = len(batch["meta"])
        if not n_scenes:        # a last batch that does not divide: rank 0's
            continue
        # the batch's first scene in the evaluation order
        n_global = min(bs, len(dataset) - i * bs)
        first = i * bs + (r * n_global // n_dp if n_global % n_dp == 0 else 0)
        out = fwd(to_device(batch, device))
        img_key = "image_fine" if "image_fine" in out else "image"
        dep_key = "depth_fine" if "depth_fine" in out else "depth"

        for j in range(n_scenes):
            name = str(batch["meta"][j]["scene"]).split(".")[0]
            row = {"index": first + j, "name": name}
            pred = out[img_key][j].float().cpu().numpy()          # [N, H, W, 3]
            gt = np.asarray(batch["tar_rgb"][j])

            pred_m, gt_m = (pred[n_view:], gt[n_view:]) if cfg.infer.eval_novel_view_only \
                else (pred, gt)
            if pred_m.size:
                # ONE horizontal mosaic of the selected views: pooled PSNR, a
                # single SSIM and a single LPIPS call (evaluation.py:75-95)
                mosaic_p = np.concatenate(list(pred_m), axis=1)
                mosaic_g = np.concatenate(list(gt_m), axis=1)
                row["psnr"] = psnr(mosaic_p, mosaic_g)
                row["ssim"] = ssim(mosaic_p, mosaic_g, device=device)
                if lpips_vgg_fn is not None:
                    row["lpips_vgg"] = lpips_vgg_fn(mosaic_g, mosaic_p)
                if lpips_alex_fn is not None:
                    row["lpips_alex"] = lpips_alex_fn(mosaic_g, mosaic_p)

            if len(cfg.infer.eval_depth) and "tar_dep" in batch:
                row["depth"] = depth_metrics(
                    out[dep_key][j, ..., 0].float().cpu().numpy(), batch["tar_dep"][j],
                    batch["tar_msk"][j], cfg.infer.eval_depth)

            if row["index"] < 100:
                _save_panel(os.path.join(cfg.infer.save_folder, f"{name}.png"), gt, pred)

            if artifacts:
                gauss = tuple(a[j] for a in out["render_pkg"]["fine"])
                tm = np.asarray(batch["transform_mats"][j]).reshape(4, 4)
                if cfg.infer.video_frames > 0:
                    sample_j = {k: v if k == "meta" else v[j:j + 1] for k, v in batch.items()}
                    render_video(os.path.join(cfg.infer.save_folder, f"{name}_video.mp4"),
                                 gauss, cfg, tm, n_frames=cfg.infer.video_frames,
                                 sample=sample_j)
                if cfg.infer.save_mesh:
                    extract_mesh(os.path.join(cfg.infer.save_folder, f"{name}.obj"),
                                 gauss, cfg, tm)

            rows.append(row)
            print(f"[{row['index'] + 1}/{len(dataset)}] {name} "
                  f"psnr={row.get('psnr', float('nan')):.2f}")
        del out

    rows = sorted((row for part in gather_objects(rows) for row in part),
                  key=lambda row: row["index"])

    def column(key):
        return [row[key] for row in rows if key in row]

    names, psnrs, ssims = column("name"), column("psnr"), column("ssim")
    lpips_vggs, lpips_alexs, depth_accs = column("lpips_vgg"), column("lpips_alex"), \
        column("depth")
    metrics = {
        "scenes": names,
        "psnr": psnrs, "ssim": ssims,
        "lpips_vgg": lpips_vggs, "lpips_alex": lpips_alexs,
        "depth": depth_accs,
        "mean_psnr": float(np.mean(psnrs)) if psnrs else None,
        "mean_ssim": float(np.mean(ssims)) if ssims else None,
        "mean_lpips_vgg": float(np.mean(lpips_vggs)) if lpips_vggs else None,
        "mean_lpips_alex": float(np.mean(lpips_alexs)) if lpips_alexs else None,
        "mean_depth": np.mean(depth_accs, axis=0).tolist() if depth_accs else None,
    }
    if is_main():
        out_path = os.path.join(cfg.infer.metric_path, f"{ds_cfg.dataset_name}.json")
        with open(out_path, "w") as f:
            json.dump(metrics, f, indent=2)
        print(f"metrics -> {out_path}")
        if metrics["mean_psnr"] is not None:
            print(f"mean PSNR {metrics['mean_psnr']:.3f}  mean SSIM {metrics['mean_ssim']:.4f}")
    return metrics


def depth_metrics(depth_pred, depth_gt, mask, thresholds) -> List[float]:
    """[mean |err|, acc@τ for each τ] within the object mask
    (evaluate.py:116-123)."""
    mask = np.asarray(mask).astype(bool)
    accs = [float(abs_error(depth_pred, depth_gt, mask).mean())]
    return accs + [float(acc_threshold(depth_pred, depth_gt, mask, t).mean())
                   for t in thresholds]


def _try_load_lpips(net: str = "vgg", required: bool = False, device="cpu"):
    """LPIPS needs pretrained VGG / Alex weights. When they are missing or
    corrupt, warn LOUDLY and skip the metric, or raise under
    infer.require_lpips=True (the reference always raises,
    evaluation.py:48-49)."""
    try:
        return load_lpips(net=net, device=device)
    except Exception as e:
        if required:
            raise RuntimeError(
                f"LPIPS-{net} weights unavailable and infer.require_lpips=True: "
                f"{e!r}. Convert them with tools/convert_lpips.py.") from e
        warnings.warn(
            f"LPIPS-{net} weights unavailable ({e!r}) — the lpips_{net} "
            "metric will be MISSING from the report. Convert weights with "
            "tools/convert_lpips.py or set infer.require_lpips=True to fail "
            "instead.", RuntimeWarning, stacklevel=2)
        return None


def _save_panel(path: str, gt: np.ndarray, pred: np.ndarray) -> None:
    """The gt views over the predicted ones, 8 bits as evaluate.py writes
    them."""
    panel = np.concatenate([np.concatenate(list(gt), axis=1),
                            np.concatenate(list(pred), axis=1)], axis=0)
    write_png(path, (panel * 255).clip(0, 255).astype(np.uint8))


if __name__ == "__main__":
    main()
