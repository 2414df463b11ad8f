"""The port's evaluation datasets (GSO, instant3d, mipnerf360), their file
readers, and the Lightning checkpoint converter, against the JAX package
or against the library the JAX package calls, on the same files made from
a seed, on the CPU at test size.

Bars:
- `read_png` against `imageio.v2.imread`: equal values, dtype and shape,
  on files from Pillow, OpenCV and a writer here that forces each row
  filter (colour types 0/2/3/4/6, bit depths 1-16); interlaced files raise.
- `resize` against `cv2.resize`: uint8 bit for bit (INTER_LINEAR RGBA and
  INTER_AREA RGB at 512→256, 512→64, 512→384 and 256→512); float32 RGB
  INTER_LINEAR within 1e-6.
- `kmeans_labels` against `sklearn.cluster.KMeans(n_init=10,
  random_state=20211202)`: the labels equal, label for label, on 20 seeded
  camera layouts at 2-6 clusters (written against scikit-learn 1.9.0).
- Each dataset's samples: every key and `meta` bit for bit (GSO's
  `tar_dep` at its file's size in both packages).
- GSO end to end, `evaluate.main` of both packages on one folder with the
  JAX package's PRNGKey(0) weights in f32: PSNR within 0.05 dB and SSIM
  within 5e-3 per scene (tests/test_torch_eval.py's bars), depth abs-error
  within 1e-4 and each accuracy threshold within 2e-3.
- `load_lightning_checkpoint` equal, tensor for tensor, to the JAX
  converter's tree carried across (`params_from_jax`), and the forward of
  both packages on it at tests/test_torch_model.py's serving bar.
"""

import dataclasses
import functools
import json
import os
import struct
import subprocess
import sys
import types
import zlib

import cv2
import imageio.v2 as imageio
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import sklearn
import torch
from PIL import Image
from sklearn.cluster import KMeans

import evaluate as jax_evaluate
import lara_tpu.models as jax_models
from lara_tpu.config import DatasetConfig as JaxDatasetConfig
from lara_tpu.config import load_config as jax_load_config
from lara_tpu.data import DataLoader as JaxDataLoader
from lara_tpu.data.gso import GSODataset as JaxGSO
from lara_tpu.data.instant3d import Instant3DDataset as JaxInstant3D
from lara_tpu.data.mipnerf import MipNeRF360Dataset as JaxMipNeRF
from lara_tpu.models.convert import convert_network_state_dict
from lara_tpu_torch import evaluate
from lara_tpu_torch.config import DatasetConfig, config_from_dict, load_config
from lara_tpu_torch.data import GSODataset, Instant3DDataset, MipNeRF360Dataset
from lara_tpu_torch.data.image_io import (INTER_AREA, INTER_LINEAR, encode_png, read_pfm,
                                          read_png, resize)
from lara_tpu_torch.data.kmeans import kmeans_groups, kmeans_labels
from lara_tpu_torch.data.synthetic import (write_gso_folder, write_instant3d_folder,
                                           write_llff_folder)
from lara_tpu_torch.eval.render_artifacts import render_video
from lara_tpu_torch.models import LaRaNet
from lara_tpu_torch.models.convert import load_lightning_checkpoint, params_from_jax
from lara_tpu_torch.train import checkpoint
from lara_tpu_torch.train.state import TrainState
from lara_tpu_torch.train.step import make_forward
from tests.test_model import synthetic_batch, tiny_config
from tests.test_torch_blend import one_torch_thread, pallas_interpret  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = "configs/synthetic.yaml"


# ------------------------------------------------------------------ PNG

def _smooth(h, w, c, hi=255, seed=0):
    """An image with gradients and noise, so every filter type has work."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([(x * 3 + y * 2 + k * 40) * (hi // 255 or 1) for k in range(c)], -1)
    noise = rng.integers(-3 * (hi // 255 or 1), 4 * (hi // 255 or 1), (h, w, c))
    return np.clip(base + noise, 0, hi) % (hi + 1)


def _filter_row(raw, prev, bpp, f):
    """One row of bytes filtered with type f (PNG spec §9)."""
    r, p = raw.astype(np.int32), prev.astype(np.int32)
    a = np.concatenate([np.zeros(bpp, np.int32), r[:-bpp]])
    c = np.concatenate([np.zeros(bpp, np.int32), p[:-bpp]])
    if f == 0:
        pred = np.zeros_like(r)
    elif f == 1:
        pred = a
    elif f == 2:
        pred = p
    elif f == 3:
        pred = (a + p) // 2
    else:
        pa, pb, pc = np.abs(p - c), np.abs(a - c), np.abs(a + p - 2 * c)
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, p, c))
    return ((r - pred) % 256).astype(np.uint8)


def _rows(samples, depth):
    """Samples [h, w, ch] → packed bytes per row [h, stride]."""
    h, w, ch = samples.shape
    if depth == 16:
        return samples.astype(">u2").view(np.uint8).reshape(h, w * ch * 2)
    if depth == 8:
        return samples.astype(np.uint8).reshape(h, w * ch)
    bits = ((samples.reshape(h, w * ch)[..., None] >> np.arange(depth - 1, -1, -1)) & 1)
    return np.packbits(bits.reshape(h, -1).astype(np.uint8), axis=1)


def _write_png(path, samples, ctype, depth, filt, palette=None, interlace=False):
    """A PNG whose every row is filtered with `filt`; Adam7 with `interlace`."""
    samples = samples.reshape(samples.shape[0], samples.shape[1], -1)
    bpp = max(1, samples.shape[2] * depth // 8)
    passes = ([(0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4),
               (1, 0, 2, 2), (0, 1, 1, 2)] if interlace else [(0, 0, 1, 1)])
    body = b""
    for x0, y0, dx, dy in passes:
        sub = samples[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        rows = _rows(sub, depth)
        prev = np.zeros(rows.shape[1], np.uint8)
        for row in rows:
            body += bytes([filt]) + _filter_row(row, prev, bpp, filt).tobytes()
            prev = row

    def chunk(tag, data):
        return struct.pack(">I", len(data)) + tag + data + struct.pack(
            ">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    h, w = samples.shape[:2]
    out = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0,
                                                             0, int(interlace)))
    if palette is not None:
        out += chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    out += chunk(b"IDAT", zlib.compress(body)) + chunk(b"IEND", b"")
    with open(path, "wb") as f:
        f.write(out)
    return str(path)


def _same_as_imageio(path):
    want, got = imageio.imread(path), read_png(path)
    assert got.dtype == want.dtype and got.shape == want.shape, (got.dtype, got.shape,
                                                                want.dtype, want.shape)
    np.testing.assert_array_equal(got, want)


FORMS = [(0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16), (3, 1), (3, 2), (3, 4),
         (3, 8), (4, 8), (4, 16), (6, 8), (6, 16)]


@pytest.mark.parametrize("ctype,depth", FORMS)
def test_read_png_every_filter(tmp_path, ctype, depth):
    """Each of the five row filters forced on every row, at 19×23 (odd
    widths leave partial bytes at sub-byte depths)."""
    ch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    hi = 2 ** depth - 1
    palette = None
    if ctype == 3:
        palette = np.random.default_rng(depth).integers(0, 256, (2 ** depth, 3))
    samples = _smooth(19, 23, ch, hi=hi, seed=depth)
    for f in range(5):
        _same_as_imageio(_write_png(tmp_path / f"f{f}.png", samples, ctype, depth, f,
                                    palette))


def test_read_png_interlaced_raises(tmp_path):
    path = _write_png(tmp_path / "adam7.png", _smooth(16, 16, 3), 2, 8, 4, interlace=True)
    assert imageio.imread(path).shape == (16, 16, 3)          # a valid file
    with pytest.raises(ValueError, match="adam7.png.*interlaced"):
        read_png(path)


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA", "P4", "P256", "1", "I;16"])
def test_read_png_pillow(tmp_path, mode):
    """Pillow's encoder chooses its row filters itself."""
    rng = np.random.default_rng(0)
    path = str(tmp_path / "pil.png")
    if mode.startswith("P"):
        img = Image.fromarray(_smooth(40, 33, 3).astype(np.uint8)).convert(
            "P", palette=Image.ADAPTIVE, colors=int(mode[1:]))
    elif mode == "1":
        img = Image.fromarray(rng.integers(0, 2, (21, 13)).astype(bool))
    elif mode == "I;16":
        img = Image.fromarray(_smooth(40, 33, 1, hi=65535)[..., 0].astype(np.uint16))
    else:
        ch = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4}[mode]
        arr = _smooth(40, 33, ch).astype(np.uint8)
        img = Image.fromarray(arr[..., 0] if ch == 1 else arr, mode=mode)
    img.save(path)
    _same_as_imageio(path)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("ch", [1, 3, 4])
def test_read_png_opencv(tmp_path, dtype, ch):
    hi = np.iinfo(dtype).max
    arr = _smooth(37, 50, ch, hi=hi).astype(dtype)
    path = str(tmp_path / "cv.png")
    assert cv2.imwrite(path, arr[..., 0] if ch == 1 else arr)
    _same_as_imageio(path)


def test_encode_png_round_trip(tmp_path):
    """The port's writer (every row filter, in turn and adaptively) read
    back by imageio and by `read_png`."""
    for ch in (1, 2, 3, 4):
        arr = _smooth(31, 27, ch).astype(np.uint8)
        for filters in (0, 1, 2, 3, 4, "cycle", "adaptive"):
            path = tmp_path / f"enc{ch}_{filters}.png"
            path.write_bytes(encode_png(arr[..., 0] if ch == 1 else arr, filters))
            np.testing.assert_array_equal(imageio.imread(path).reshape(arr.shape), arr)
            _same_as_imageio(str(path))


def test_read_pfm_matches_jax(tmp_path):
    from lara_tpu.data.gso import read_pfm as jax_read_pfm
    from lara_tpu_torch.data.image_io import write_pfm

    for shape in ((9, 7), (9, 7, 3)):
        data = np.random.default_rng(1).normal(size=shape).astype(np.float32)
        write_pfm(str(tmp_path / "d.pfm"), data)
        got, want = read_pfm(str(tmp_path / "d.pfm")), jax_read_pfm(str(tmp_path / "d.pfm"))
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[0], data)
        assert got[1] == want[1] == 1.0


# --------------------------------------------------------------- resize

SIZES = [(512, 256), (512, 64), (512, 384), (256, 512)]


@pytest.mark.parametrize("src,dst", SIZES)
@pytest.mark.parametrize("case", ["u8-linear-rgba", "u8-area-rgb", "f32-linear-rgb"])
def test_resize_matches_opencv(case, src, dst):
    kind, interp, ch = case.split("-")
    img = _smooth(src, src, len(ch), seed=src + dst).astype(np.uint8)
    img[::7] = np.random.default_rng(dst).integers(0, 256, img[::7].shape)   # edges
    if kind == "f32":
        img = img.astype(np.float32) / 255.0
    flag = {"linear": (cv2.INTER_LINEAR, INTER_LINEAR), "area": (cv2.INTER_AREA, INTER_AREA)}
    want = cv2.resize(img, (dst, dst), interpolation=flag[interp][0])
    got = resize(img, (dst, dst), flag[interp][1])
    assert got.dtype == want.dtype and got.shape == want.shape
    if kind == "u8":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


# --------------------------------------------------------------- KMeans

def test_sklearn_version():
    """The KMeans port follows this version's algorithm and order."""
    assert sklearn.__version__ == "1.9.0"


@pytest.mark.parametrize("seed", range(20))
def test_kmeans_matches_sklearn(seed):
    """A camera layout near a sphere (16-48 positions, jittered; some on an
    upper cap), every cluster count 2-6."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(16, 49))
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    if seed % 3 == 0:
        d[:, 1] = np.abs(d[:, 1])
    xyz = (d * rng.uniform(1.2, 2.5) + rng.normal(scale=0.05, size=(n, 3))).astype(np.float32)
    for k in range(2, 7):
        want = KMeans(k, n_init=10, random_state=20211202).fit(xyz).labels_
        np.testing.assert_array_equal(kmeans_labels(xyz, k), want, err_msg=f"k={k}")
    from lara_tpu.data.gso import kmeans_groups as jax_kmeans_groups

    for got, want in zip(kmeans_groups(xyz, 4), jax_kmeans_groups(xyz, 4)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------- datasets

@pytest.fixture(scope="module")
def folders(tmp_path_factory):
    """GSO (2 scenes × 16 views at 512², depth at 512² and, in a second
    folder, at 64²), instant3d (2 mosaics of 128² tiles) and an LLFF
    capture (16 views stored at 128×96, served at 64×48)."""
    d = tmp_path_factory.mktemp("infer_folders")
    return {"gso": write_gso_folder(str(d / "gso"), n_scenes=2, n_views=16, size=512),
            "gso64": write_gso_folder(str(d / "gso64"), n_scenes=2, n_views=16, size=512,
                                      depth_size=64, seed=1),
            "i3d": write_instant3d_folder(str(d / "i3d"), n_scenes=2, tile=128),
            "llff": write_llff_folder(str(d / "llff"), n_views=16, size=(64, 48))}


def _same_sample(got, want, skip=()):
    assert set(got) == set(want)
    assert got["meta"] == want["meta"]
    for k in want:
        if k == "meta" or k in skip:
            continue
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, (k, g.dtype, g.shape, w.dtype, w.shape)
        np.testing.assert_array_equal(g, w, err_msg=k)


@pytest.mark.parametrize("split,size", [("test", 64), ("train", 64), ("test", 512)])
def test_gso_matches_jax(folders, split, size):
    kw = dict(data_root=folders["gso"], split=split, img_size=(size, size), n_group=2)
    want_ds = JaxGSO(JaxDatasetConfig(**kw), rng=np.random.default_rng(7))
    got_ds = GSODataset(DatasetConfig(**kw), rng=np.random.default_rng(7))
    assert list(got_ds.scenes_name) == list(want_ds.scenes_name)
    for s in got_ds.scenes_name:
        for key in ("groups", "groups_4"):
            for g, w in zip(got_ds.scene_infos[s][key], want_ds.scene_infos[s][key]):
                np.testing.assert_array_equal(g, w)
    for i in range(len(want_ds)):
        want, got = want_ds[i], got_ds[i]
        assert len(want["meta"]["tar_view"]) == (6 if split == "test" else 4)
        _same_sample(got, want)
        assert got["tar_dep"].shape[1:] == (512, 512)       # the PFM's size, as in JAX
        if size == 512:
            # the mask comes from the blended alpha, so silhouette pixels
            # may miss the sphere at their centre
            assert got["tar_msk"].any() and (got["tar_dep"][got["tar_msk"] > 0] > 0).mean() > 0.9


def test_instant3d_matches_jax(folders):
    for size in (64, 128):
        kw = dict(data_root=folders["i3d"], img_size=(size, size))
        want_ds, got_ds = JaxInstant3D(JaxDatasetConfig(**kw)), Instant3DDataset(
            DatasetConfig(**kw))
        assert len(got_ds) == len(want_ds) == 2
        for i in range(2):
            _same_sample(got_ds[i], want_ds[i])


@pytest.mark.parametrize("split", ["test", "train"])
def test_mipnerf_matches_jax(folders, split):
    kw = dict(data_root=folders["llff"], split=split, img_size=(64, 48))
    want_ds = JaxMipNeRF(JaxDatasetConfig(**kw), rng=np.random.default_rng(1))
    got_ds = MipNeRF360Dataset(DatasetConfig(**kw), rng=np.random.default_rng(1))
    assert len(got_ds) == len(want_ds) == 1000
    np.testing.assert_array_equal(got_ds.imgs, want_ds.imgs)
    assert got_ds.imgs.shape[1:] == (48, 64, 3)
    for i in range(2):
        _same_sample(got_ds[i], want_ds[i])


# ------------------------------------------------------ GSO end to end

GSO_ARGS = ["infer_dataset.dataset_name=GSO", "infer_dataset.img_size=[64,64]",
            "infer_dataset.batch_size=1", "infer_dataset.num_workers=0",
            "infer.eval_depth=[0.005,0.01,0.02]"]


def _jax_params(jcfg, f32_net, dataset):
    """The weights JAX evaluate.main draws: PRNGKey(0) at the shapes of the
    first batch."""
    sample = next(iter(JaxDataLoader(dataset, 1, num_workers=0, drop_last=False)))
    arrays = {k: jnp.asarray(v) for k, v in sample.items() if k != "meta"}
    jnet = f32_net(jcfg)
    return jax.jit(lambda r: jnet.init(r, arrays, with_fine=True, train=False))(
        jax.random.PRNGKey(0))


def test_gso_evaluate_matches_jax(folders, tmp_path, monkeypatch):
    """JAX `evaluate.main` (its LaRaNet held in f32) and the port's
    `evaluate.main(dtype=float32, --device cpu)` on one GSO folder (512²
    renders served at 64², depth at 64²), with depth metrics."""
    root = folders["gso64"]
    f32_net = functools.partial(jax_models.LaRaNet, dtype=jnp.float32)
    monkeypatch.setattr(jax_models, "LaRaNet", f32_net)
    args = [CONFIG, *GSO_ARGS, f"infer_dataset.data_root={root}"]
    want = jax_evaluate.main(args + [f"infer.save_folder={tmp_path}/jax",
                                     f"infer.metric_path={tmp_path}/jax_m"])
    assert want["scenes"] == ["object_000", "object_001"]

    jcfg = jax_load_config("configs/base.yaml", "configs/infer.yaml", CONFIG, overrides=args[1:])
    params = _jax_params(jcfg, f32_net, JaxGSO(jcfg.infer_dataset))
    cfg = config_from_dict(dataclasses.asdict(jcfg))
    net = LaRaNet(cfg, dtype=torch.float32, device="cpu")
    net.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params["params"])),
                        strict=True)
    checkpoint.save_checkpoint(str(tmp_path / "ckpts"), TrainState(net, cfg.train, 1), epoch=0)

    got = evaluate.main(args + [f"infer.ckpt_path={tmp_path}/ckpts",
                                f"infer.save_folder={tmp_path}/pt",
                                f"infer.metric_path={tmp_path}/pt_m", "--device", "cpu"],
                        dtype=torch.float32)
    assert got["scenes"] == want["scenes"]
    np.testing.assert_allclose(got["psnr"], want["psnr"], rtol=0, atol=0.05)
    np.testing.assert_allclose(got["ssim"], want["ssim"], rtol=0, atol=5e-3)
    got_d, want_d = np.array(got["depth"]), np.array(want["depth"])
    assert got_d.shape == want_d.shape == (2, 4) and np.isfinite(got_d).all()
    np.testing.assert_allclose(got_d[:, 0], want_d[:, 0], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got_d[:, 1:], want_d[:, 1:], rtol=0, atol=2e-3)
    with open(tmp_path / "pt_m" / "GSO.json") as f:
        assert set(json.load(f)) == set(want)


def test_instant3d_evaluate_writes_video(folders, tmp_path):
    """A 4-view instant3d sample has no novel view: no PSNR, as in the JAX
    package; the orbit video is still rendered."""
    got = evaluate.main([CONFIG, "infer_dataset.dataset_name=instant3d",
                         f"infer_dataset.data_root={folders['i3d']}", "n_views=4",
                         "infer_dataset.img_size=[64,64]", "infer.video_frames=2",
                         f"infer.save_folder={tmp_path}/o", f"infer.metric_path={tmp_path}/m",
                         "--device", "cpu"])
    assert got["scenes"] == ["scene_00", "scene_01"]
    assert got["psnr"] == [] and got["mean_psnr"] is None
    for name in got["scenes"]:
        video = tmp_path / "o" / f"{name}_video.mp4"
        frames = tmp_path / "o" / f"{name}_video"
        assert video.is_file() or sorted(os.listdir(frames)) == ["frame_0000.png",
                                                                 "frame_0001.png"]


def test_mipnerf_sample_renders_video(folders, tmp_path):
    """Two mipnerf360 samples through `make_forward` and the LLFF spiral of
    `render_video` (evaluate's loop would run the nominal 1000 samples); the
    train split, as the 16-view capture holds out 2 views only."""
    cfg = load_config("configs/base.yaml", "configs/infer.yaml", CONFIG, overrides=[
        "infer_dataset.dataset_name=mipnerf360", f"infer_dataset.data_root={folders['llff']}",
        "infer_dataset.split=train", "n_views=4", "infer_dataset.img_size=[64,48]"])
    ds = MipNeRF360Dataset(cfg.infer_dataset)
    fwd = make_forward(LaRaNet(cfg, dtype=torch.float32, device="cpu"), return_buffer=True)
    for i in range(2):
        sample = ds[i]
        batch = {k: v if k == "meta" else torch.from_numpy(np.asarray(v)[None])
                 for k, v in sample.items()}
        out = fwd(batch)
        assert out["image_fine"].shape == (1, 4, 48, 64, 3)
        gauss = tuple(a[0] for a in out["render_pkg"]["fine"])
        written = render_video(str(tmp_path / f"s{i}_video.mp4"), gauss, cfg,
                               np.eye(4, dtype=np.float32), n_frames=2,
                               sample={k: v if k == "meta" else np.asarray(v)[None]
                                       for k, v in sample.items()})
        assert os.path.exists(written)


# ------------------------------------------------- Lightning checkpoints

class _Unimportable:
    """Stands for a Lightning / OmegaConf object in the checkpoint's
    hyper-parameters; its module is gone when the file is read."""

    def __init__(self, lr):
        self.lr = lr


def _lightning_payload(path, sd):
    """A Lightning-format file: `state_dict` with the network under `net.`,
    timm keys the network never reads, a key of another module, and an
    object whose class cannot be imported on load."""
    mod = types.ModuleType("lightning_stand_in")
    cls = type("AttributeDict", (_Unimportable,), {"__module__": "lightning_stand_in"})
    mod.AttributeDict = cls
    sys.modules["lightning_stand_in"] = mod
    extra = {"net.img_encoder.model.head.weight": torch.randn(10, 48),
             "net.img_encoder.model.head.bias": torch.randn(10),
             "net.img_encoder.model.fc_norm.weight": torch.randn(48),
             "loss.lpips.lin0.weight": torch.randn(1, 64, 1, 1)}
    payload = {"state_dict": {**{"net." + k: v for k, v in sd.items()}, **extra},
               "hyper_parameters": cls(4e-4), "epoch": 29, "global_step": 1234,
               "optimizer_states": [{"state": {}, "param_groups": [{"lr": 4e-4}]}]}
    try:
        torch.save(payload, path)
    finally:
        del sys.modules["lightning_stand_in"]
    with pytest.raises(ModuleNotFoundError):
        torch.load(path, weights_only=False)
    return sorted(extra)


def _reference_weights(cfg, seed=0):
    """Reference-named weights at `cfg`'s sizes: the port's init, perturbed."""
    net = LaRaNet(cfg, dtype=torch.float32, device="cpu")
    gen = torch.Generator().manual_seed(seed)
    return {k: v + 0.05 * torch.randn(v.shape, generator=gen) for k, v in
            net.state_dict().items()}


def test_lightning_checkpoint_matches_jax_converter(tmp_path, pallas_interpret):  # noqa: F811
    jcfg = tiny_config()
    jcfg = dataclasses.replace(jcfg, render=dataclasses.replace(jcfg.render, backend="pallas"))
    cfg = config_from_dict(dataclasses.asdict(jcfg))
    sd = _reference_weights(cfg)
    path = str(tmp_path / "epoch=29.ckpt")
    extra = _lightning_payload(path, sd)
    m = cfg.model

    got, dropped = load_lightning_checkpoint(path, num_layers=m.num_layers,
                                             encoder_depth=m.encoder_depth)
    assert dropped == extra
    tree = convert_network_state_dict({k: v.numpy() for k, v in sd.items()},
                                      num_layers=m.num_layers, encoder_depth=m.encoder_depth)
    want = params_from_jax(tree)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == torch.float32
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)

    net = LaRaNet(cfg, dtype=torch.float32, device="cpu")
    load_lightning_checkpoint(path, net, num_layers=m.num_layers, encoder_depth=m.encoder_depth)
    batch = synthetic_batch(B=1)
    jnet = jax_models.LaRaNet(jcfg, dtype=jnp.float32)
    ref = jnet.apply({"params": tree}, batch, with_fine=True, train=False)
    out = make_forward(net)({k: torch.from_numpy(np.array(v)) for k, v in batch.items()})
    for key, atol in (("image", 1e-3), ("acc_map", 1e-3), ("image_fine", 1e-3),
                      ("acc_map_fine", 1e-3), ("depth", 5e-3), ("depth_fine", 5e-3)):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key], np.float32),
                                   atol=atol, err_msg=key)


def test_lightning_checkpoint_rejects_unknown_and_missing_keys(tmp_path):
    cfg = load_config("configs/base.yaml", CONFIG)
    m = cfg.model
    sd = _reference_weights(cfg)
    torch.save({"state_dict": {**{"net." + k: v for k, v in sd.items()},
                               "net.vol_decoder.layers.2.norm1.weight": torch.ones(64)}},
               tmp_path / "extra_layer.ckpt")
    with pytest.raises(ValueError, match="vol_decoder.layers.2.norm1.weight"):
        load_lightning_checkpoint(str(tmp_path / "extra_layer.ckpt"), num_layers=m.num_layers,
                                  encoder_depth=m.encoder_depth)
    torch.save({k: v for k, v in sd.items() if k != "decoder.norm.bias"},
               tmp_path / "bare.pt")
    with pytest.raises(KeyError, match="decoder.norm.bias"):
        load_lightning_checkpoint(str(tmp_path / "bare.pt"), num_layers=m.num_layers,
                                  encoder_depth=m.encoder_depth)


def test_convert_checkpoint_cli_then_evaluate(folders, tmp_path):
    """`python -m lara_tpu_torch.tools.convert_checkpoint` in a subprocess,
    then `evaluate --device cpu` from its output: the metrics of the same
    weights saved through the port's checkpoint API."""
    cfg = load_config("configs/base.yaml", CONFIG)
    sd = _reference_weights(cfg, seed=3)
    ckpt = str(tmp_path / "epoch=29.ckpt")
    _lightning_payload(ckpt, sd)
    res = subprocess.run([sys.executable, "-m", "lara_tpu_torch.tools.convert_checkpoint",
                          ckpt, str(tmp_path / "converted"), CONFIG], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "converted 86 tensors" in res.stdout
    with open(tmp_path / "converted" / "parity_report.json") as f:
        report = json.load(f)
    assert set(report) == set(sd)
    k = "decoder.norm.weight"
    assert report[k]["shape"] == list(sd[k].shape)
    np.testing.assert_allclose(report[k]["absmax"], float(sd[k].abs().max()))

    net = LaRaNet(cfg, dtype=torch.float32, device="cpu")
    net.load_state_dict(sd, strict=True)
    checkpoint.save_checkpoint(str(tmp_path / "direct"), TrainState(net, cfg.train, 1), epoch=0)
    args = [CONFIG, *GSO_ARGS, f"infer_dataset.data_root={folders['gso64']}", "--device", "cpu"]
    runs = [evaluate.main(args + [f"infer.ckpt_path={tmp_path}/{d}",
                                  f"infer.save_folder={tmp_path}/{d}_o",
                                  f"infer.metric_path={tmp_path}/{d}_m"], dtype=torch.float32)
            for d in ("converted", "direct")]
    assert runs[0] == runs[1]
    assert np.isfinite(runs[0]["mean_psnr"]) and len(runs[0]["depth"]) == 2
