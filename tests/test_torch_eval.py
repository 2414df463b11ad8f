"""The port's evaluation against the JAX package's, on the CPU at test size.

Inputs come from `numpy.random.default_rng(seed)`; each check holds the
port's function against its JAX counterpart on the same inputs.

Tolerances:
- `psnr`, `abs_error`, `acc_threshold`: the same float64 / NumPy code on
  both sides, so equal; `ssim`: f32 on both sides, within 1e-5.
- LPIPS on random weights: relative 1e-4 (f32 convolutions in another
  order through 5 VGG / Alex stages).
- `video_path`, the TSDF and its mesh: equal (NumPy on both sides; the
  port's TSDF updates only the voxels a view observes, with the same
  arithmetic). `pose_interp`: within 1e-6 (the quaternion conversions run
  in torch and in jnp, f32).
- `_render_frames`: the serving slice's atol 1e-3 on image / acc_map, 5e-3
  on depth (tests/test_torch_model.py).
- End to end, per scene: PSNR within 0.05 dB, SSIM within 5e-3 (the bar of
  tests/test_eval.py:test_evaluate_dp_sharded_matches_single); scene names
  equal.
"""

import dataclasses
import functools
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import evaluate as jax_evaluate
import lara_tpu.models as jax_models
from lara_tpu.config import load_config as jax_load_config
from lara_tpu.data import DataLoader as JaxDataLoader
from lara_tpu.data.synthetic import SyntheticDataset as JaxSyntheticDataset
from lara_tpu.data.synthetic import _orbit_c2w, render_spheres, write_synthetic_h5
from lara_tpu.eval import lpips as jax_lpips
from lara_tpu.eval import metrics as jax_metrics
from lara_tpu.eval import pose_interp as jax_pose_interp
from lara_tpu.eval import render_artifacts as jax_artifacts
from lara_tpu.eval import tsdf as jax_tsdf
from lara_tpu.eval import video_path as jax_video_path
from lara_tpu.utils.quat import rotmat_to_quat as jax_rotmat_to_quat
from lara_tpu.utils.camera import build_rays_np
from lara_tpu_torch import eval_all, evaluate
from lara_tpu_torch.config import config_from_dict
from lara_tpu_torch.data import write_synthetic_store
from lara_tpu_torch.eval import lpips, metrics, pose_interp, render_artifacts, tsdf, video_path
from lara_tpu_torch.models import LaRaNet
from lara_tpu_torch.models.convert import params_from_jax
from lara_tpu_torch.ops.rasterizer import cuda_blend
from lara_tpu_torch.train import checkpoint
from lara_tpu_torch.train.state import TrainState
from lara_tpu_torch.utils.camera import fov_to_ixt
from lara_tpu_torch.utils.quat import rotmat_to_quat
from tests.test_torch_blend import one_torch_thread  # noqa: F401

CONFIG = "configs/synthetic.yaml"


def _mosaics(seed=0, shape=(64, 256, 3)):
    rng = np.random.default_rng(seed)
    gt = rng.uniform(size=shape).astype(np.float32)
    pred = np.clip(gt + rng.normal(size=shape) * 0.1, 0, 1).astype(np.float32)
    return pred, gt


def test_metrics_match_jax():
    pred, gt = _mosaics()
    assert metrics.psnr(pred, gt) == jax_metrics.psnr(pred, gt)
    assert metrics.psnr(gt, gt) == jax_metrics.psnr(gt, gt) == float("inf")
    np.testing.assert_allclose(metrics.ssim(pred, gt), jax_metrics.ssim(pred, gt), atol=1e-5)
    np.testing.assert_allclose(metrics.ssim(torch.from_numpy(pred), gt),
                               jax_metrics.ssim(pred, gt), atol=1e-5)

    rng = np.random.default_rng(1)
    dg = rng.uniform(1.0, 2.0, (64, 256)).astype(np.float32)
    dp = dg + rng.normal(size=dg.shape).astype(np.float32) * 0.01
    mask = rng.uniform(size=dg.shape) < 0.6
    np.testing.assert_array_equal(metrics.abs_error(dp, dg, mask),
                                  jax_metrics.abs_error(dp, dg, mask))
    for t in (0.005, 0.01, 0.02):
        np.testing.assert_array_equal(metrics.acc_threshold(dp, dg, mask, t),
                                      jax_metrics.acc_threshold(dp, dg, mask, t))


LPIPS_LINS = {"vgg": [64, 128, 256, 512, 512], "alex": [64, 192, 384, 256, 256]}


def _write_lpips_npz(path, net, seed=0):
    """Random weights of `net` in tools/convert_lpips.py's layout (HWIO
    convolutions, He-scaled so activations keep their size through the
    stack, and the `lin` weights)."""
    rng = np.random.default_rng(seed)
    arrays, cin, i = {}, 3, 0
    for v in (lpips._VGG_CFG if net == "vgg" else lpips._ALEX_CFG):
        if v == "M":
            continue
        co, k = (v, 3) if net == "vgg" else v[:2]
        arrays[f"{net}_w{i}"] = (rng.normal(size=(k, k, cin, co)) * np.sqrt(2 / (k * k * cin))
                                 ).astype(np.float32)
        arrays[f"{net}_b{i}"] = (rng.normal(size=co) * 0.01).astype(np.float32)
        cin, i = co, i + 1
    for i, co in enumerate(LPIPS_LINS[net]):
        arrays[f"lin{i}"] = rng.uniform(size=co).astype(np.float32)
    np.savez(path, **arrays)
    return str(path)


@pytest.fixture(scope="module")
def lpips_npz(tmp_path_factory):
    d = tmp_path_factory.mktemp("lpips")
    return {net: _write_lpips_npz(d / f"lpips_{net}.npz", net) for net in LPIPS_LINS}


@pytest.mark.parametrize("net", ["vgg", "alex"])
def test_lpips_matches_jax(lpips_npz, net):
    pred, gt = _mosaics(seed=2, shape=(64, 64, 3))
    fn = lpips.load_lpips(lpips_npz[net], net=net)
    want = jax_lpips.load_lpips(lpips_npz[net], net=net)(gt, pred)
    got = fn(gt, pred)
    assert want > 1e-3
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert fn(gt, gt) < 1e-6


def test_lpips_missing_weights_raise(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setitem(lpips._DEFAULT_PATHS, "vgg", ("weights/lpips_vgg.npz",))
    with pytest.raises(FileNotFoundError):
        lpips.load_lpips(net="vgg")
    with pytest.raises(RuntimeError, match="require_lpips"):
        evaluate._try_load_lpips("vgg", required=True)
    with pytest.warns(RuntimeWarning, match="MISSING"):
        assert evaluate._try_load_lpips("vgg", required=False) is None


@pytest.mark.parametrize("net", ["vgg", "alex"])
def test_lpips_golden(net):
    """The converted real weights, where they are in the repository: the
    port's LPIPS equals the JAX package's on a seeded pair."""
    path = os.path.join(os.path.dirname(__file__), "..", "weights", f"lpips_{net}.npz")
    if not os.path.exists(path):
        pytest.skip(f"weights/lpips_{net}.npz is not in the repository "
                    "(tools/convert_lpips.py writes it)")
    pred, gt = _mosaics(seed=3, shape=(64, 64, 3))
    np.testing.assert_allclose(lpips.load_lpips(path, net=net)(gt, pred),
                               jax_lpips.load_lpips(path, net=net)(gt, pred), rtol=1e-4)


def _same_cameras(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.c2w, b.c2w)
        np.testing.assert_array_equal(a.ixt, b.ixt)
        assert (a.width, a.height, a.fovx, a.fovy, a.znear, a.zfar) == \
            (b.width, b.height, b.fovx, b.fovy, b.znear, b.zfar)


def test_video_and_mesh_paths_match_jax():
    rng = np.random.default_rng(4)
    tm = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    tm4 = np.eye(4, dtype=np.float32)
    tm4[:3, :3] = tm * np.sign(np.linalg.det(tm))
    for name in ("synthetic", "instant3d"):
        _same_cameras(video_path.uni_video_path(12, name, (64, 48), tm4),
                      jax_video_path.uni_video_path(12, name, (64, 48), tm4))
        _same_cameras(video_path.uni_mesh_path(8, name, (64, 48), tm4),
                      jax_video_path.uni_mesh_path(8, name, (64, 48), tm4))
    c2ws = np.tile(np.eye(4), (12, 1, 1))
    c2ws[:, :3, 3] = rng.normal(scale=[0.5, 0.3, 0.1], size=(12, 3))
    near_fars = np.tile(np.array([1.2, 8.0]), (12, 1))
    _same_cameras(video_path.uni_video_path(20, "mipnerf360", (64, 48), c2ws=c2ws,
                                            near_fars=near_fars, fov=(0.6, 0.5)),
                  jax_video_path.uni_video_path(20, "mipnerf360", (64, 48), c2ws=c2ws,
                                                near_fars=near_fars, fov=(0.6, 0.5)))
    with pytest.raises(ValueError):
        video_path.uni_video_path(8, "mipnerf360", (64, 48))


def test_pose_interp_matches_jax():
    rng = np.random.default_rng(5)
    rots = np.linalg.qr(rng.normal(size=(64, 3, 3)))[0]
    rots *= np.sign(np.linalg.det(rots))[:, None, None]
    np.testing.assert_allclose(rotmat_to_quat(torch.from_numpy(rots.astype(np.float32))).numpy(),
                               np.asarray(jax_rotmat_to_quat(jnp.asarray(rots, jnp.float32))),
                               atol=1e-6)
    poses = np.concatenate([rots[:5], rng.normal(size=(5, 3, 1))], axis=2).astype(np.float32)
    ixts = np.tile(fov_to_ixt([0.7, 0.7], [64, 64])[None], (5, 1, 1))
    ixts[:, 0, 0] += np.arange(5)
    for order in (False, True):
        got = pose_interp.get_interpolated_poses_many(poses, ixts, 6, order_poses=order)
        want = jax_pose_interp.get_interpolated_poses_many(poses, ixts, 6, order_poses=order)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, atol=1e-6)


def test_tsdf_mesh_matches_jax(tmp_path):
    """The sphere scene of tests/test_eval.py:test_tsdf_sphere_reconstruction
    fused by both volumes: the same volume, mesh, clusters and .obj."""
    radius, center = 0.3, np.zeros(3, np.float32)
    spheres = [(center, radius, np.array([1.0, 0.2, 0.2], np.float32))]
    H = W = 96
    ixt = fov_to_ixt(np.array([0.8, 0.8], np.float32), np.array([W, H]))
    aabb = np.array([[-0.5, -0.5, -0.5], [0.5, 0.5, 0.5]])
    vols = [m.TSDFVolume(aabb, voxel_size=1.5 / 96, sdf_trunc=0.05) for m in (tsdf, jax_tsdf)]
    for k in range(12):
        c2w = _orbit_c2w(1.6, k * np.pi / 6, 0.3 * np.sin(k))
        rays = build_rays_np(c2w[None], ixt[None], H, W, 1.0)[0]
        o, d = rays[..., :3], rays[..., 3:]
        dn = d / np.linalg.norm(d, axis=-1, keepdims=True)
        b = np.sum(o * dn, -1)
        disc = b * b - (np.sum(o * o, -1) - radius ** 2)
        t = -b - np.sqrt(np.maximum(disc, 0))
        depth = np.where((disc > 0) & (t > 0), t * (dn @ c2w[:3, 2]), 0.0).astype(np.float32)
        color = render_spheres(c2w, ixt, H, W, spheres)[0][..., :3].astype(np.float32) / 255
        for vol in vols:
            vol.integrate(depth, color, ixt, np.linalg.inv(c2w))
    for name in ("tsdf", "weight", "color"):
        np.testing.assert_array_equal(getattr(vols[0], name), getattr(vols[1], name))
    meshes = [vol.extract_mesh() for vol in vols]
    assert len(meshes[0][2]) > 500
    for mod, mesh in zip((tsdf, jax_tsdf), meshes):
        mesh += mod.keep_largest_clusters(*mesh, keep=1)
        mod.save_obj(str(tmp_path / f"{mod.__name__}.obj"), mesh[3], mesh[5], mesh[4])
    for got, want in zip(*meshes):
        np.testing.assert_array_equal(got, want)
    assert (tmp_path / f"{tsdf.__name__}.obj").read_text() == \
        (tmp_path / f"{jax_tsdf.__name__}.obj").read_text()


def test_render_frames_match_jax():
    """Both packages' `_render_frames` on one surfel set (raw parameters, as
    the fine buffer holds them) from 3 orbit cameras at 64²."""
    jcfg = jax_load_config("configs/base.yaml", CONFIG)
    tcfg = config_from_dict(dataclasses.asdict(jcfg))
    rng = np.random.default_rng(6)
    n = 1500
    gauss = (rng.uniform(-0.3, 0.3, (n, 3)),
             rng.normal(size=(n, 4, 3)) * 0.3 + [[1], [0], [0], [0]],
             rng.normal(-1.0, 1.5, (n, 1)), np.log(0.02) + rng.normal(size=(n, 2)) * 0.3,
             rng.normal(size=(n, 4)))
    gauss = tuple(a.astype(np.float32) for a in gauss)
    cams = video_path.uni_video_path(3, "synthetic", (64, 64))
    want = jax_artifacts._render_frames(jax_video_path.uni_video_path(3, "synthetic", (64, 64)),
                                        gauss, jcfg, (64, 64))
    before = dict(cuda_blend.LAUNCHES)
    got = render_artifacts._render_frames(cams, tuple(map(torch.from_numpy, gauss)), tcfg,
                                          (64, 64))
    assert cuda_blend.LAUNCHES == before                  # CPU: the plain version
    assert len(got) == 3
    for g, w in zip(got, want):
        assert set(g) == set(w)
        assert w["acc_map"].max() > 0.1
        for key, atol in (("image", 1e-3), ("acc_map", 1e-3), ("depth", 5e-3)):
            np.testing.assert_allclose(g[key], w[key], atol=atol, err_msg=key)


EVAL_ARGS = ["infer_dataset.dataset_name=synthetic", "infer_dataset.img_size=[64,64]",
             "infer_dataset.batch_size=1", "infer_dataset.num_workers=0"]


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """12 scenes at 64² (2 held out: scenes 0 and 10) as the JAX package's
    HDF5 shard and the port's store, from one seed."""
    d = tmp_path_factory.mktemp("eval_stores")
    return (write_synthetic_h5(str(d / "syn.h5"), n_scenes=12, img_size=(64, 64)),
            write_synthetic_store(str(d / "syn"), n_scenes=12, img_size=(64, 64)))


def test_evaluate_matches_jax(stores, tmp_path, monkeypatch):
    """JAX `evaluate.main` (its LaRaNet held in f32 here) and the port's
    `evaluate.main(dtype=float32)` on the same scenes and weights: the JAX
    package's PRNGKey(0) init, carried across by `params_from_jax` and
    saved through the port's checkpoint API."""
    h5, store = stores
    f32_net = functools.partial(jax_models.LaRaNet, dtype=jnp.float32)
    monkeypatch.setattr(jax_models, "LaRaNet", f32_net)
    want = jax_evaluate.main([CONFIG, *EVAL_ARGS, f"infer_dataset.data_root={h5}",
                              f"infer.save_folder={tmp_path}/jax",
                              f"infer.metric_path={tmp_path}/jax_m"])
    assert want["scenes"] == ["scene_0000", "scene_0010"]

    # the weights evaluate.py:48-50 drew: PRNGKey(0) at the shapes of the
    # first batch
    jcfg = jax_load_config("configs/base.yaml", "configs/infer.yaml", CONFIG, overrides=[
        *EVAL_ARGS, f"infer_dataset.data_root={h5}"])
    sample = next(iter(JaxDataLoader(JaxSyntheticDataset(jcfg.infer_dataset), 1,
                                     num_workers=0, drop_last=False)))
    arrays = {k: jnp.asarray(v) for k, v in sample.items() if k != "meta"}
    jnet = f32_net(jcfg)
    params = jax.jit(lambda r: jnet.init(r, arrays, with_fine=True, train=False))(
        jax.random.PRNGKey(0))
    cfg = config_from_dict(dataclasses.asdict(jcfg))
    net = LaRaNet(cfg, dtype=torch.float32, device="cpu")
    net.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params["params"])),
                        strict=True)
    checkpoint.save_checkpoint(str(tmp_path / "ckpts"), TrainState(net, cfg.train, 1), epoch=0)

    got = evaluate.main([CONFIG, *EVAL_ARGS, f"infer_dataset.data_root={store}",
                         f"infer.ckpt_path={tmp_path}/ckpts", f"infer.save_folder={tmp_path}/pt",
                         f"infer.metric_path={tmp_path}/pt_m", "--device", "cpu"],
                        dtype=torch.float32)
    assert got["scenes"] == want["scenes"]
    np.testing.assert_allclose(got["psnr"], want["psnr"], rtol=0, atol=0.05)
    np.testing.assert_allclose(got["ssim"], want["ssim"], rtol=0, atol=5e-3)
    with open(tmp_path / "pt_m" / "synthetic.json") as f:
        assert set(json.load(f)) == set(want)
    assert sorted(os.listdir(tmp_path / "pt")) == ["scene_0000.png", "scene_0010.png"]


def test_evaluate_cli_writes_artifacts(stores, tmp_path, monkeypatch):
    """`python -m lara_tpu_torch.evaluate configs/synthetic.yaml --device cpu
    ...` (its `main`, in this process) on the store's first held-out scene,
    with the video and the mesh, where OpenCV does not import: the metrics
    JSON with the keys of evaluate.py, the panel, the video's PNG frames
    and a non-empty .obj."""
    monkeypatch.setitem(sys.modules, "cv2", None)         # import cv2 raises
    out = tmp_path / "out"
    got = evaluate.main([CONFIG, *EVAL_ARGS, f"infer_dataset.data_root={stores[1]}",
                         "infer_dataset.n_scenes=1", "infer.video_frames=3",
                         "infer.save_mesh=True", f"infer.save_folder={out}",
                         f"infer.metric_path={tmp_path}/m", "--device", "cpu"])
    with open(tmp_path / "m" / "synthetic.json") as f:
        saved = json.load(f)
    assert saved == got
    assert set(saved) == {"scenes", "psnr", "ssim", "lpips_vgg", "lpips_alex", "depth",
                          "mean_psnr", "mean_ssim", "mean_lpips_vgg", "mean_lpips_alex",
                          "mean_depth"}
    assert saved["scenes"] == ["scene_0000"] and np.isfinite(saved["mean_psnr"])
    assert sorted(os.listdir(out)) == ["scene_0000.obj", "scene_0000.png", "scene_0000_video"]
    assert sorted(os.listdir(out / "scene_0000_video")) == [f"frame_{i:04d}.png"
                                                            for i in range(3)]
    lines = (out / "scene_0000.obj").read_text().splitlines()
    assert sum(ln.startswith("v ") for ln in lines) > 100
    assert sum(ln.startswith("f ") for ln in lines) > 100


def test_evaluate_depth_and_lpips_branch(stores, tmp_path, monkeypatch, lpips_npz):
    """The per-scene metrics of a stub forward on a stub batch with `tar_dep`
    (two scenes in one batch), with LPIPS weights present: the depth
    metrics, PSNR, SSIM and LPIPS as the JAX package's evaluate.py computes
    them from the same arrays."""
    import lara_tpu_torch.data.gobjverse as gobjverse

    getitem = gobjverse.GObjaverseDataset.__getitem__

    def with_depth(self, index):
        sample = getitem(self, index)
        rng = np.random.default_rng(index)
        sample["tar_dep"] = rng.uniform(1.0, 2.5, sample["tar_msk"].shape).astype(np.float32)
        return sample

    def stub_forward(net, with_fine, return_buffer, render_scale):
        assert with_fine and not return_buffer and render_scale == 1.0

        def fwd(batch):
            rgb, dep = batch["tar_rgb"], batch["tar_dep"]
            wave = torch.sin(torch.arange(dep[0].numel(), dtype=torch.float32)
                             ).reshape(dep.shape[1:])
            return {"image_fine": rgb * 0.8 + 0.1 * wave[..., None],
                    "depth_fine": (dep + 0.03 * wave)[..., None]}
        return fwd

    monkeypatch.setattr(gobjverse.GObjaverseDataset, "__getitem__", with_depth)
    monkeypatch.setattr(evaluate, "make_forward", stub_forward)
    monkeypatch.setattr(lpips, "_DEFAULT_PATHS", {k: (v,) for k, v in lpips_npz.items()})
    thresholds = [0.005, 0.01, 0.02]
    got = evaluate.main([CONFIG, *EVAL_ARGS, "infer_dataset.batch_size=2",
                         f"infer_dataset.data_root={stores[1]}",
                         f"infer.eval_depth=[{','.join(map(str, thresholds))}]",
                         f"infer.save_folder={tmp_path}/o", f"infer.metric_path={tmp_path}/m",
                         "--device", "cpu"])

    jcfg = jax_load_config("configs/base.yaml", "configs/infer.yaml", CONFIG, overrides=[
        *EVAL_ARGS, f"infer_dataset.data_root={stores[0]}"])
    ds = JaxSyntheticDataset(jcfg.infer_dataset)
    lp = {net: jax_lpips.load_lpips(lpips_npz[net], net=net) for net in lpips_npz}
    want = {"psnr": [], "ssim": [], "lpips_vgg": [], "lpips_alex": [], "depth": []}
    n_in = jcfg.n_views
    for j in range(len(ds)):
        sample = ds[j]
        dep = np.random.default_rng(j).uniform(1.0, 2.5, sample["tar_msk"].shape)
        dep = dep.astype(np.float32)
        wave = np.sin(np.arange(dep.size, dtype=np.float32)).reshape(dep.shape)
        pred = sample["tar_rgb"] * np.float32(0.8) + np.float32(0.1) * wave[..., None]
        mp, mg = (np.concatenate(list(a[n_in:]), axis=1) for a in (pred, sample["tar_rgb"]))
        want["psnr"].append(jax_metrics.psnr(mp, mg))
        want["ssim"].append(jax_metrics.ssim(mp, mg))
        for net in lpips_npz:
            want[f"lpips_{net}"].append(lp[net](mg, mp))
        dp, mask = dep + np.float32(0.03) * wave, sample["tar_msk"].astype(bool)
        want["depth"].append(
            [float(jax_metrics.abs_error(dp, dep, mask).mean())]
            + [float(jax_metrics.acc_threshold(dp, dep, mask, t).mean()) for t in thresholds])
    assert got["scenes"] == ["scene_0000", "scene_0010"]
    np.testing.assert_allclose(got["psnr"], want["psnr"], rtol=1e-6)
    np.testing.assert_allclose(got["ssim"], want["ssim"], atol=1e-5)
    for net in lpips_npz:
        np.testing.assert_allclose(got[f"lpips_{net}"], want[f"lpips_{net}"], rtol=1e-4)
    np.testing.assert_allclose(got["depth"], want["depth"], rtol=1e-6)
    np.testing.assert_allclose(got["mean_depth"], np.mean(want["depth"], axis=0), rtol=1e-6)
    assert 0.0 < got["mean_depth"][1] < got["mean_depth"][3] < 1.0


def test_eval_loader_keeps_the_last_batch():
    """evaluate's loader (`drop_last=False`) batches as the JAX package's."""
    data = [{"x": np.full(2, i, np.float32), "meta": {"scene": str(i)}} for i in range(5)]
    from lara_tpu_torch.data import DataLoader

    for drop_last in (True, False):
        got = [b["x"][:, 0].tolist() for b in DataLoader(data, 2, num_workers=0,
                                                         drop_last=drop_last)]
        want = [b["x"][:, 0].tolist() for b in JaxDataLoader(data, 2, num_workers=0,
                                                             drop_last=drop_last)]
        assert got == want
    assert len(DataLoader(data, 2, drop_last=False)) == 3


def test_evaluate_runs_on_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        evaluate.main([CONFIG])


def test_eval_all_runs_every_benchmark(monkeypatch, capsys):
    """The four runs of eval_all.py as `python -m lara_tpu_torch.evaluate`
    subprocesses; a failed run is reported and the next one starts."""
    monkeypatch.setattr(sys, "argv", ["eval_all.py"])
    import eval_all as jax_eval_all

    calls = []

    def call(cmd):
        calls.append(cmd)
        return 3 if len(calls) == 2 else 0

    monkeypatch.setattr(eval_all.subprocess, "call", call)
    assert eval_all.main(["logs/run/ckpts", "--device", "cpu"]) == [0, 3, 0, 0]
    assert [name for name, _ in eval_all.RUNS] == [name for name, _ in jax_eval_all.RUNS]
    for cmd, (name, overrides) in zip(calls, jax_eval_all.RUNS):
        assert cmd[:3] == [sys.executable, "-m", "lara_tpu_torch.evaluate"]
        assert cmd[3:] == ["n_views=4", "infer.ckpt_path=logs/run/ckpts",
                           f"infer.metric_path=outputs/metrics/{name}", *overrides,
                           "--device=cpu"]
    assert "[eval_all] gobjeverse failed with code 3" in capsys.readouterr().out
