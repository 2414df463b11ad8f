"""Import hygiene of the port: every module of `lara_tpu_torch`, and
`chip_smoke.py`, imports in a fresh interpreter without pulling in JAX, flax, the JAX package, PyYAML,
h5py, OpenCV, imageio, scikit-learn or Pillow (the GPU machine has none of
the last six); loading the configs does not pull them in either."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

FORBIDDEN = ("jax", "flax", "lara_tpu", "yaml", "h5py", "cv2", "imageio", "sklearn", "PIL")
REPO = Path(__file__).resolve().parents[1]

_PROBE = """
import importlib, json, pkgutil, sys
import lara_tpu_torch
names = ["lara_tpu_torch"] + [m.name for m in pkgutil.walk_packages(
    lara_tpu_torch.__path__, "lara_tpu_torch.")]
for name in names + ["chip_smoke"]:
    importlib.import_module(name)
from lara_tpu_torch.config import load_config
load_config("configs/base.yaml", "configs/synthetic256.yaml", overrides=["train.lr=1e-4"])
print(json.dumps({"modules": names,
                  "loaded": sorted({m.split(".")[0] for m in sys.modules})}))
"""


@pytest.fixture(scope="module")
def probe():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_every_module_imports(probe):
    expected = {"lara_tpu_torch.models.lara", "lara_tpu_torch.ops.rasterizer.cuda_blend",
                "lara_tpu_torch.train.step", "lara_tpu_torch.config",
                "lara_tpu_torch.train.loss", "lara_tpu_torch.train.state",
                "lara_tpu_torch.ops.msssim", "lara_tpu_torch.models.remat",
                "lara_tpu_torch.tools.profile_train",
                "lara_tpu_torch.ops.rasterizer.cuda_windows",
                "lara_tpu_torch.tools.workload", "lara_tpu_torch.tools.profile_binning",
                "lara_tpu_torch.utils.camera", "lara_tpu_torch.data",
                "lara_tpu_torch.data.decode", "lara_tpu_torch.data.synthetic",
                "lara_tpu_torch.data.gobjverse", "lara_tpu_torch.data.loader",
                "lara_tpu_torch.train.checkpoint", "lara_tpu_torch.train.loop",
                "lara_tpu_torch.train.__main__", "lara_tpu_torch.eval.vis",
                "lara_tpu_torch.eval.metrics", "lara_tpu_torch.eval.lpips",
                "lara_tpu_torch.eval.video_path", "lara_tpu_torch.eval.pose_interp",
                "lara_tpu_torch.eval.tsdf", "lara_tpu_torch.eval.render_artifacts",
                "lara_tpu_torch.evaluate", "lara_tpu_torch.eval_all",
                "lara_tpu_torch.data.image_io", "lara_tpu_torch.data.kmeans",
                "lara_tpu_torch.data.gso", "lara_tpu_torch.data.instant3d",
                "lara_tpu_torch.data.mipnerf", "lara_tpu_torch.models.convert",
                "lara_tpu_torch.tools.convert_checkpoint",
                "lara_tpu_torch.parallel.distributed", "lara_tpu_torch.parallel.mesh",
                "lara_tpu_torch.parallel.tp", "lara_tpu_torch.data.mvgen",
                "lara_tpu_torch.tools.mesh_render", "lara_tpu_torch.tools.h5_to_store",
                "lara_tpu_torch.ops.rasterizer.reference", "lara_tpu_torch.tools.timing",
                "lara_tpu_torch.tools.validate_fine_budget",
                "lara_tpu_torch.tools.sweep_eval_budgets", "lara_tpu_torch.tools.ab_dup",
                "lara_tpu_torch.tools.sweep_chunk", "lara_tpu_torch.tools.ab_kernels",
                "lara_tpu_torch.tools.profile_rasterizer", "lara_tpu_torch.tools.profile_loss",
                "lara_tpu_torch.tools.profile_input_pipeline"}
    assert expected <= set(probe["modules"])


@pytest.mark.parametrize("name", FORBIDDEN)
def test_no_forbidden_import(probe, name):
    assert name not in probe["loaded"]
