"""The port's single-image → 3D front end (`lara_tpu_torch/data/mvgen.py`),
its stand-in generators and the mesh turntable
(`lara_tpu_torch/tools/mesh_render.py`) against the JAX package's
`lara_tpu/data/mvgen.py` and `tools/mesh_render.py`, on the same inputs
from `numpy.random.default_rng(seed)`.

Tolerances:
- cameras within 1e-6; `slice_grid`, `pad_to_square` and the alpha matte
  bit for bit (the port labels 4-connected components with scipy, the JAX
  module with OpenCV);
- generated views and batches within 1e-6, the float32 bar of
  `data/image_io.py:resize` against `cv2.resize` (INTER_AREA up and down);
- mesh turntable frames bit for bit (the same NumPy operations).
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

import lara_tpu.data.mvgen as jax_mvgen
import tools.mesh_render as jax_mesh_render
from lara_tpu.config import DatasetConfig as JaxDatasetConfig
from lara_tpu.utils.camera import fov_to_ixt
from lara_tpu_torch import evaluate
from lara_tpu_torch.config import DatasetConfig, load_config
from lara_tpu_torch.data import get_dataset, mvgen
from lara_tpu_torch.data.image_io import encode_png
from lara_tpu_torch.data.synthetic import fake_zero123plus_pipeline, sphere_mvgen_pipeline
from lara_tpu_torch.eval import tsdf
from lara_tpu_torch.eval.video_path import uni_mesh_path
from lara_tpu_torch.tools import mesh_render
from tests.test_datasets import fake_zero123plus_pipeline as jax_fake_pipeline
from tests.test_eval import _uv_sphere
from tests.test_torch_blend import one_torch_thread  # noqa: F401

BACKENDS = ["zero123plus-v1.1", "zero123plus-v1.2", "sv3d"]


def test_cameras_and_constants_match_jax():
    assert mvgen.RIGS == jax_mvgen.RIGS
    assert mvgen.ZERO123_SUBSET == jax_mvgen.ZERO123_SUBSET
    assert mvgen.SV3D_FRAMES == jax_mvgen.SV3D_FRAMES
    assert mvgen.SV3D_AZIMUTHS == jax_mvgen.SV3D_AZIMUTHS
    for backend in BACKENDS:
        for got, want in zip(mvgen.rig_cameras(backend), jax_mvgen.rig_cameras(backend)):
            assert got.dtype == want.dtype
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    rng = np.random.default_rng(0)
    poses = np.stack([rng.uniform(-80, 80, 7), rng.uniform(0, 720, 7)], 1).tolist()
    for got, want in zip(mvgen.generate_input_camera(1.9, poses, fov=41.0),
                         jax_mvgen.generate_input_camera(1.9, poses, fov=41.0)):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)

    grid = rng.uniform(size=(9, 8, 3)).astype(np.float32)
    for got, want in zip(mvgen.slice_grid(grid, 3, 2), jax_mvgen.slice_grid(grid, 3, 2)):
        np.testing.assert_array_equal(got, want)
    for shape in [(5, 9, 3), (8, 3, 4), (6, 6, 3)]:
        img = rng.uniform(size=shape).astype(np.float32)
        got, want = mvgen.pad_to_square(img), jax_mvgen.pad_to_square(img)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(mvgen.fxfycxcy_to_pixel_ixt(np.array([1.1, 1.2, 0.5, 0.4]),
                                                              64, 48),
                                  jax_mvgen.fxfycxcy_to_pixel_ixt(np.array([1.1, 1.2, 0.5, 0.4]),
                                                                  64, 48))


def _matte_case(name):
    """Images whose background-like components the 4-connected labelling
    must classify: enclosed holes stay opaque, components reaching the
    border key out."""
    rng = np.random.default_rng(7)
    gray, red = np.float32(0.5), np.array([0.9, 0.2, 0.1], np.float32)
    if name == "jax":                                  # tests/test_datasets.py:167
        img = np.full((64, 64, 3), gray, np.float32)
        img[16:48, 16:48] = [0.9, 0.2, 0.1]
        img[28:36, 28:36] = 0.5
        return img
    img = np.full((48, 56, 3), gray, np.float32)
    if name == "seeded_holes":
        img += rng.normal(scale=0.02, size=img.shape).astype(np.float32)
        for _ in range(5):
            y, x = rng.integers(1, 30), rng.integers(1, 38)
            h, w = rng.integers(8, 17, 2)
            img[y:y + h, x:x + w] = rng.uniform(0.0, 1.0, 3) * [1, 0.2, 1]
            img[y + 3:y + h - 3, x + 3:x + w - 3] = gray + rng.normal(scale=0.02)
        return img
    img[4:44, 4:52] = red
    if name == "channel_to_border":
        img[10:20, 10:20] = gray                       # a pool ...
        img[0:10, 14] = gray                           # ... reaching one border pixel
        img[25:35, 30:40] = gray                       # an enclosed pool
        img[0:4, 52:56] = red                          # the corner's block
        img[0, 55] = gray                              # the corner pixel alone
        img[1, 54] = gray                              # diagonal to it: a hole
        return img
    assert name == "diagonal"
    img[3, 4] = img[4, 3] = red                        # (4, 4) meets (3, 3) diagonally
    for k in range(4, 10):
        img[k, k] = gray                               # a diagonal staircase
    img[10:16, 10:16] = gray                           # a pool diagonal to it
    img[20:24, 40:44] = gray
    img[24, 44] = gray                                 # joined diagonally
    return img


@pytest.mark.parametrize("name", ["jax", "seeded_holes", "channel_to_border", "diagonal"])
def test_alpha_matte_bit_for_bit(name):
    img = _matte_case(name)
    got, want = mvgen.estimate_alpha_matte(img), jax_mvgen.estimate_alpha_matte(img)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(mvgen.matte_white(img), jax_mvgen.matte_white(img))
    a = got[..., 0]
    assert a[0, 0] == 0.0                              # the border's background keys out
    if name == "diagonal":                             # 4-connectivity: holes, opaque
        assert a[4, 4] == a[7, 7] == a[12, 12] == a[24, 44] == 1.0
    if name == "channel_to_border":
        assert a[15, 15] == a[0, 14] == 0.0 and a[30, 35] == a[1, 54] == 1.0


def _pipelines(backend, size):
    """Random generator output for `backend`: a 3×2 grid of size² tiles or
    21 frames of size²."""
    rng = np.random.default_rng(size)
    if backend == "sv3d":
        return rng.uniform(size=(21, size, size, 3)).astype(np.float32)
    return rng.uniform(size=(3 * size, 2 * size, 3)).astype(np.float32)


@pytest.mark.parametrize("backend", BACKENDS)
def test_generate_matches_jax(backend):
    """Injected pipelines: INTER_AREA up (40² → 64²) and down (96², 72² →
    64²), the matte for zero123plus, the rig cameras; and text → 3D."""
    image = np.random.default_rng(1).uniform(size=(30, 44, 3)).astype(np.float32)
    sizes = (72,) if backend == "sv3d" else (40, 96)
    for size in sizes:
        out = _pipelines(backend, size)
        got = mvgen.MultiViewGenerator(backend, pipeline=lambda im: out).generate(
            image=image, img_size=64)
        want = jax_mvgen.MultiViewGenerator(backend, pipeline=lambda im: out).generate(
            image=image, img_size=64)
        assert got[0].shape == (4, 64, 64, 3) and got[0].dtype == np.float32
        np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-6)
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[2], want[2])
    if backend == "sv3d":
        return
    got = mvgen.MultiViewGenerator(backend, pipeline=fake_zero123plus_pipeline,
                                   text_to_image=lambda p: image).generate(prompt="a chair",
                                                                           img_size=64)
    want = jax_mvgen.MultiViewGenerator(backend, pipeline=jax_fake_pipeline,
                                        text_to_image=lambda p: image).generate(
        prompt="a chair", img_size=64)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-6)


def test_generator_errors_match_jax(monkeypatch):
    for mod in (mvgen, jax_mvgen):
        with pytest.raises(NotImplementedError):
            mod.MultiViewGenerator("zero123plus-v1.1", pipeline=fake_zero123plus_pipeline
                                   ).generate(prompt="no backend")
        with pytest.raises(ValueError):
            mod.MultiViewGenerator("nope")
        with pytest.raises(ValueError):
            mod.MultiViewGenerator().generate()
        with pytest.raises(RuntimeError):
            mod.MultiViewGenerator("sv3d").generate(image=np.ones((8, 8, 3), np.float32))
    monkeypatch.setitem(sys.modules, "diffusers", None)    # import diffusers raises
    for mod in (mvgen, jax_mvgen):
        with pytest.raises(ImportError):
            mod.MultiViewGenerator().generate(image=np.ones((8, 8, 3), np.float32))
    with pytest.raises(ImportError, match="pipeline="):
        mvgen.MultiViewGenerator().generate(image=np.ones((8, 8, 3), np.float32))


def test_fake_pipeline_and_batch_match_jax():
    image = np.random.default_rng(2).uniform(size=(20, 20, 3)).astype(np.float32)
    np.testing.assert_array_equal(fake_zero123plus_pipeline(image), jax_fake_pipeline(image))
    views = np.random.default_rng(3).uniform(size=(4, 64, 64, 3)).astype(np.float32)
    c2ws, fxfycxcy = jax_mvgen.rig_cameras("zero123plus-v1.2")
    got = mvgen.build_mvgen_batch(views, c2ws, fxfycxcy)
    want = jax_mvgen.build_mvgen_batch(views, c2ws, fxfycxcy)
    _assert_batches_close(got, want)


def _assert_batches_close(got, want):
    assert set(got) == set(want)
    assert got["meta"] == want["meta"]
    for k in want:
        if k != "meta":
            a, b = np.asarray(got[k]), np.asarray(want[k])
            assert a.shape == b.shape and a.dtype == b.dtype, k
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6, err_msg=k)


@pytest.fixture(scope="module")
def cond_folder(tmp_path_factory):
    """An RGBA 30×40 and an RGB 48² conditioning PNG (and a JPEG name the
    folder glob picks up)."""
    d = tmp_path_factory.mktemp("mvgen_cond")
    rng = np.random.default_rng(4)
    rgba = rng.integers(0, 256, (30, 40, 4), dtype=np.uint8)
    rgb = rng.integers(0, 256, (48, 48, 3), dtype=np.uint8)
    (d / "b_rgba.png").write_bytes(encode_png(rgba))
    (d / "a_rgb.png").write_bytes(encode_png(rgb))
    return d


def test_dataset_matches_jax(cond_folder, monkeypatch):
    """A folder of an RGBA and an RGB PNG with the JAX fixture injected on
    both sides: the same scene order and batches within 1e-6."""
    got_ds = get_dataset("mvgen")(DatasetConfig(data_root=str(cond_folder), img_size=(64, 64)),
                                  pipeline=jax_fake_pipeline)
    want_ds = jax_mvgen.MVGenDataset(JaxDatasetConfig(data_root=str(cond_folder),
                                                      img_size=(64, 64)),
                                     pipeline=jax_fake_pipeline)
    assert isinstance(got_ds, mvgen.MVGenDataset)
    assert got_ds.image_paths == want_ds.image_paths and len(got_ds) == len(want_ds) == 2
    for i in range(2):
        _assert_batches_close(got_ds[i], want_ds[i])
        assert got_ds[i]["meta"]["scene"] == str(i)

    monkeypatch.setitem(sys.modules, "diffusers", None)
    for ds in (mvgen.MVGenDataset(got_ds.cfg),
               jax_mvgen.MVGenDataset(want_ds.cfg)):
        assert len(ds) == 2
        with pytest.raises(ImportError):
            ds[0]

    jpg = cond_folder / "c.jpg"
    jpg.write_bytes(b"\xff\xd8\xff\xe0")
    try:
        ds = mvgen.MVGenDataset(got_ds.cfg, pipeline=jax_fake_pipeline)
        assert ds.image_paths[-1] == str(jpg)
        with pytest.raises(ValueError, match="c.jpg"):
            ds[2]
    finally:
        jpg.unlink()


@pytest.mark.parametrize("backend", BACKENDS)
def test_sphere_pipelines_render_the_rig(backend):
    """The stand-in generators: zero123plus tiles 0, 2, 4, 5 and sv3d
    frames 0, 4, 8, 12 are renders of one scene from the rig's cameras,
    so the batch's views are the scene seen from the batch's cameras."""
    image = np.full((16, 16, 3), 0.3, np.float32)
    size = 48
    out = sphere_mvgen_pipeline(backend, size=size)(image)
    c2ws, fxfycxcy = mvgen.rig_cameras(backend)
    if backend == "sv3d":
        assert out.shape == (21, size, size, 3)
        views, bg = out[mvgen.SV3D_FRAMES], 1.0
    else:
        assert out.shape == (3 * size, 2 * size, 3)
        views = [mvgen.slice_grid(out, 3, 2)[i] for i in mvgen.ZERO123_SUBSET]
        bg = 0.5
    again = sphere_mvgen_pipeline(backend, size=size)
    assert np.array_equal(again(image), out)
    for view, c2w in zip(views, c2ws):
        assert view.dtype == np.float32 and 0 <= view.min() and view.max() <= 1
        fg = np.any(view != np.float32(bg), -1)
        assert 0.05 < fg.mean() < 0.8                      # one object in view, not cut
        assert not fg[0].any() and not fg[-1].any() and not fg[:, 0].any()
    views, c2ws_gen, _ = mvgen.MultiViewGenerator(
        backend, pipeline=sphere_mvgen_pipeline(backend, size=size)).generate(
        image=image, img_size=32)
    np.testing.assert_array_equal(c2ws_gen, c2ws)
    assert np.allclose(views[:, 0, 0], 1.0, atol=0.02)    # matted or white


def test_evaluate_on_generated_views(cond_folder, tmp_path, monkeypatch,
                                     one_torch_thread):  # noqa: F811
    """`_evaluate` on the CPU with an injected `MVGenDataset` at the tiny
    config (4 views, all inputs, so no novel view): panels, the 2-frame
    videos as PNG frames, and the JSON with the keys of evaluate.py and
    null means (evaluate.py:149-158)."""
    monkeypatch.setitem(sys.modules, "cv2", None)
    cfg = load_config(*(str(evaluate.CONFIGS / n) for n in ("base.yaml", "infer.yaml",
                                                            "synthetic.yaml")), overrides=[
                          "n_views=4", "infer_dataset.dataset_name=mvgen",
                          "infer_dataset.img_size=[64,64]", "infer_dataset.num_workers=0",
                          f"infer_dataset.data_root={cond_folder}", "infer.video_frames=2",
                          f"infer.save_folder={tmp_path}/out",
                          f"infer.metric_path={tmp_path}/m"])
    ds = mvgen.MVGenDataset(cfg.infer_dataset, pipeline=fake_zero123plus_pipeline)
    got = evaluate._evaluate(cfg, torch.device("cpu"), torch.float32, dataset=ds)
    with open(tmp_path / "m" / "mvgen.json") as f:
        saved = json.load(f)
    assert saved == got
    assert set(saved) == {"scenes", "psnr", "ssim", "lpips_vgg", "lpips_alex", "depth",
                          "mean_psnr", "mean_ssim", "mean_lpips_vgg", "mean_lpips_alex",
                          "mean_depth"}
    assert saved["scenes"] == ["0", "1"] and saved["psnr"] == []
    assert all(saved[k] is None for k in saved if k.startswith("mean_"))
    assert sorted(os.listdir(tmp_path / "out")) == ["0.png", "0_video", "1.png", "1_video"]
    for s in ("0", "1"):
        assert sorted(os.listdir(tmp_path / "out" / f"{s}_video")) == ["frame_0000.png",
                                                                       "frame_0001.png"]


# ------------------------------------------------------- the mesh turntable


def _triangle():
    verts = np.array([[-0.3, -0.3, 0.0], [0.3, -0.3, 0.0], [0.0, 0.4, 0.0]], np.float32)
    return verts, np.array([[0, 1, 2]])


@pytest.mark.parametrize("mesh,colors", [("triangle", False), ("triangle", True),
                                         ("sphere", False), ("sphere", True)])
def test_mesh_turntable_bit_for_bit(mesh, colors):
    """tests/test_eval.py:123's triangle and :157's UV sphere, through the
    JAX tool's `render_mesh_view` and the port's, with and without vertex
    colours, from the front and from a turntable camera."""
    verts, faces = _triangle() if mesh == "triangle" else _uv_sphere()
    size = 64 if mesh == "triangle" else 96
    col = (np.random.default_rng(5).uniform(size=verts.shape).astype(np.float32)
           if colors else None)
    c2w = np.eye(4, dtype=np.float32)
    c2w[2, 3] = -2.0
    ixt = fov_to_ixt(np.array([0.8, 0.8]), np.array([size, size]))
    orbit = uni_mesh_path(2, "gobjeverse", (size, size))[4]
    for c, k in ((c2w, ixt), (orbit.c2w, orbit.ixt)):
        got = mesh_render.render_mesh_view(verts, faces, c, k, size, size, col)
        want = jax_mesh_render.render_mesh_view(verts, faces, c, k, size, size, col)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert np.any(got != 1.0)
    hit = got[..., 0] != 1.0
    zb = np.where(hit, 1.0 + np.random.default_rng(6).uniform(size=hit.shape) * 0.1,
                  np.inf).astype(np.float32)
    np.testing.assert_array_equal(mesh_render.ssao(zb), jax_mesh_render.ssao(zb))


def test_mesh_tool_reads_tsdf_obj_and_writes_png_frames(tmp_path, monkeypatch):
    """`load_obj` reads the port's `.obj` writer as the JAX tool does, and
    `main` writes PNG frames (3 elevations × --frames) where OpenCV is
    absent, each the JAX tool's frame."""
    from lara_tpu_torch.data.image_io import read_png

    verts, faces = _uv_sphere(n_lat=8, n_lon=10)
    colors = np.random.default_rng(8).uniform(size=verts.shape).astype(np.float32)
    path = str(tmp_path / "m.obj")
    tsdf.save_obj(path, verts, faces, colors)
    got, want = mesh_render.load_obj(path), jax_mesh_render.load_obj(path)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got[0], verts)
    np.testing.assert_array_equal(got[1], faces)
    np.testing.assert_array_equal(got[2], colors)

    monkeypatch.setitem(sys.modules, "cv2", None)
    out = mesh_render.main([path, "--out", str(tmp_path / "turn.mp4"), "--frames", "2",
                            "--size", "32"])
    assert out == str(tmp_path / "turn")
    names = sorted(os.listdir(out))
    assert names == [f"frame_{i:04d}.png" for i in range(6)]
    vn = jax_mesh_render.vertex_normals(*want[:2])
    for name, cam in zip(names, uni_mesh_path(2, "gobjeverse", (32, 32))):
        img = jax_mesh_render.render_mesh_view(want[0], want[1], cam.c2w, cam.ixt, 32, 32,
                                               want[2], vn)
        np.testing.assert_array_equal(read_png(os.path.join(out, name)),
                                      (img * 255).astype(np.uint8))
