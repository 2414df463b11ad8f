"""What each training loss term costs, forward and forward + backward: the
port of `tools/profile_loss.py`.

    python -m lara_tpu_torch.tools.profile_loss [--device cuda] [--size 512] [--quick]

On fixed random tensors of the training shape (B = 3 scenes, 8 views,
512², seeded), each term of `train/loss.py:compute_losses` as it computes
it: the MSE, MS-SSIM of one head (views tiled into one [B, 3, H, 8·W]
image), the PSNR stat, the normal consistency, the distortion, and the
whole `compute_losses` at step 2000 (both heads, the gated terms on).
`fwd` times the term, `fwdbwd` the term and its gradient to the network
outputs it reads. `ms` is a host-clock slope ended by a synchronise; on the
card `dev_ms` is the device time of the same calls queued behind a sleep
kernel.
"""

from __future__ import annotations

import argparse
import json
import math

import torch

from lara_tpu_torch.ops.msssim import _MSSSIM_WEIGHTS, ms_ssim
from lara_tpu_torch.parallel.mesh import global_mean
from lara_tpu_torch.tools.timing import (FWD_REPS, FWDBWD_REPS, SIZE, banner,
                                         time_call, tool_device)
from lara_tpu_torch.train.loss import _num_scales, compute_losses

B, VIEWS = 3, 8
STEP = 2000                   # past the distortion / normal gate (step > 1000)


def run(device="cuda", size: int = SIZE, quick: bool = False, seed: int = 0) -> dict:
    dev = tool_device(device)
    banner(dev)
    gen = torch.Generator().manual_seed(seed)

    def rand(*shape, normal=False):
        x = torch.randn(shape, generator=gen) if normal else torch.rand(shape, generator=gen)
        return x.to(dev)

    shape = (B, VIEWS, size, size)
    img, tar = rand(*shape, 3), rand(*shape, 3)
    nrm, acc = rand(*shape, 3, normal=True), rand(*shape)
    dist = rand(*shape) * 1e-4
    weights = _MSSSIM_WEIGHTS[:_num_scales(size, size)]
    weights = tuple(w / sum(weights) for w in weights)

    def tiled(x):                                  # [B, N, H, W, 3] -> [B, 3, H, N·W]
        return x.permute(0, 4, 2, 1, 3).reshape(B, 3, size, VIEWS * size)

    terms = {
        "mse": (lambda o: global_mean((o["image"] - tar) ** 2), ("image",)),
        "ms_ssim": (lambda o: ms_ssim(tiled(o["image"]), tiled(tar), weights=weights),
                    ("image",)),
        "psnr": (lambda o: -10.0 * torch.log(global_mean((o["image"] - tar) ** 2))
                 / math.log(10.0), ("image",)),
        "normal": (lambda o: global_mean(
            (1.0 - torch.sum(o["rend_normal"] * o["depth_normal"], dim=-1)) * acc),
            ("rend_normal", "depth_normal")),
        "distortion": (lambda o: global_mean(o["rend_dist"]) * 1000.0, ("rend_dist",)),
        "compute_losses": (lambda o: compute_losses({"tar_rgb": tar}, o, STEP)[0],
                           ("image", "image_fine", "rend_dist", "rend_normal",
                            "depth_normal")),
    }
    rows = {}
    for name, (term, reads) in terms.items():
        leaves = {"image": img.clone(), "image_fine": img * 0.99, "rend_dist": dist.clone(),
                  "rend_normal": nrm.clone(), "depth_normal": nrm * 0.9}
        for k in reads:
            leaves[k].requires_grad_(True)
        output = {**leaves, "acc_map": acc, "acc_map_fine": acc,
                  "rend_dist_fine": dist, "rend_normal_fine": nrm,
                  "depth_normal_fine": nrm * 0.9}

        def fwd():
            with torch.no_grad():
                return term(output)

        def fwdbwd():
            return torch.autograd.grad(term(output), [leaves[k] for k in reads])

        rows[name] = {"fwd": time_call(fwd, dev, FWD_REPS, quick),
                      "fwdbwd": time_call(fwdbwd, dev, FWDBWD_REPS, quick)}
        print(f"{name:15s} fwd {rows[name]['fwd']}  fwd+bwd {rows[name]['fwdbwd']}", flush=True)
    return {"tool": "profile_loss", "device": str(dev), "size": size, "batch": B,
            "views": VIEWS, "step": STEP, "terms": rows}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--size", type=int, default=SIZE)
    ap.add_argument("--quick", action="store_true", help="few repetitions, one trial")
    a = ap.parse_args(argv)
    print(json.dumps(run(a.device, a.size, a.quick)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
