"""The port's data path against the JAX package's on the same inputs: the
camera utilities, the sample decoding, the synthetic scene store (written
as .npy, held bit for bit against the HDF5 shard of the same seed), the
dataset's samples on both splits, the loader's batch order over two
epochs, the registry, and the panels.

Tolerances: integer and u8 arrays, view ids and scene names are equal.
Float arrays of a sample (rgb, normals, rays) agree within atol 1e-6: the
JAX package may compute them in its native C helpers, whose float order
differs from NumPy's by a few ulp (1.2e-7 at most on these scenes). The
camera functions in torch f32 against JAX f32 at atol 1e-5; jet-coloured
depth panels within one 8-bit level (OpenCV's jet table against its
piecewise-linear ramps), other panels exactly.
"""

import dataclasses
import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lara_tpu.utils.camera as jcam
from lara_tpu.config import DatasetConfig as JaxDatasetConfig
from lara_tpu.data import DataLoader as JaxDataLoader
from lara_tpu.data import dataset_dict as jax_dataset_dict
from lara_tpu.data import native
from lara_tpu.data.synthetic import SyntheticDataset as JaxSyntheticDataset
from lara_tpu.data.synthetic import write_synthetic_h5
from lara_tpu.eval.vis import vis_images as jax_vis_images
from lara_tpu_torch.config import DatasetConfig
from lara_tpu_torch.data import (DataLoader, MVGenDataset, dataset_dict, device_prefetch,
                                 get_dataset,
                                 write_synthetic_store)
from lara_tpu_torch.data import decode
from lara_tpu_torch.data.gobjverse import GObjaverseDataset, H5Store, NpyStore, open_store
from lara_tpu_torch.data.synthetic import SyntheticDataset
from lara_tpu_torch.eval.vis import png_bytes, vis_images
from lara_tpu_torch.tools import h5_to_store
from lara_tpu_torch.utils import camera as tcam

SAMPLE_ATOL = 1e-6
N_SCENES = 12


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """(h5 shard, .npy store) of the same 12 scenes at 64²."""
    d = tmp_path_factory.mktemp("stores")
    h5 = write_synthetic_h5(str(d / "syn.h5"), n_scenes=N_SCENES, img_size=(64, 64))
    npy = write_synthetic_store(str(d / "syn"), n_scenes=N_SCENES, img_size=(64, 64))
    return h5, npy


def _cfgs(root_jax, root_torch, split, n_group=2):
    jc = JaxDatasetConfig(dataset_name="synthetic", data_root=root_jax, split=split,
                          img_size=(64, 64), n_group=n_group, n_scenes=N_SCENES,
                          batch_size=2, num_workers=0)
    tc = dataclasses.replace(DatasetConfig(**dataclasses.asdict(jc)), data_root=root_torch)
    return jc, tc


def _orbit(n):
    from lara_tpu_torch.data.synthetic import _orbit_c2w

    return np.stack([_orbit_c2w(1.8, 2 * np.pi * i / n, 0.1 * i) for i in range(n)])


def test_camera_utils_match_jax():
    rng = np.random.default_rng(0)
    c2ws = _orbit(3)
    w2cs = np.linalg.inv(c2ws).astype(np.float32)
    ixts = np.stack([jcam.fov_to_ixt(np.array([0.7 + 0.1 * i, 0.6]), np.array([64, 48]))
                     for i in range(3)])
    cam_j = jcam.make_camera(c2ws[1], 0.7, 0.6, 0.5, 3.0)
    cam_t = tcam.make_camera(c2ws[1], 0.7, 0.6, 0.5, 3.0, device="cpu")
    for f in ("w2c", "campos", "tanfovx", "tanfovy", "near", "far"):
        np.testing.assert_allclose(getattr(cam_t, f).numpy(), np.asarray(getattr(cam_j, f)),
                                   atol=1e-5, err_msg=f)
    np.testing.assert_allclose(cam_t.campos.numpy(), -c2ws[1, :3, 3])   # the quirk
    assert np.allclose(tcam.make_camera(c2ws[1], 0.7, 0.6, 0.5, 3.0,
                                        campos_quirk=False).campos.numpy(), c2ws[1, :3, 3])

    np.testing.assert_allclose(tcam.intrinsic_to_fov(ixts[2]), jcam.intrinsic_to_fov(ixts[2]))
    for scale in (1.0, 1.0 / 16):
        want = np.asarray(jcam.build_rays(jnp.asarray(c2ws), jnp.asarray(ixts), 48, 64, scale))
        got = tcam.build_rays(torch.from_numpy(c2ws), torch.from_numpy(ixts), 48, 64, scale)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    pts = rng.uniform(-0.5, 0.5, size=(5, 7, 3)).astype(np.float32)
    want = jcam.project_points(jnp.asarray(pts), jnp.asarray(w2cs), jnp.asarray(ixts))
    got = tcam.project_points(torch.from_numpy(pts), torch.from_numpy(w2cs),
                              torch.from_numpy(ixts))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-4)
    for a, b in zip(tcam.canonicalize_cameras_np(c2ws, w2cs),
                    jcam.canonicalize_cameras_np(c2ws, w2cs)):
        np.testing.assert_array_equal(a, b)


def test_decode_matches_jax():
    rng = np.random.default_rng(1)
    rgba = rng.integers(0, 256, size=(16, 24, 4)).astype(np.uint8)
    bg = np.array([0.5, 0.5, 0.5], np.float32)
    for a, b in zip(decode.composite_rgba(rgba, bg), native.composite_rgba(rgba, bg)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=SAMPLE_ATOL)
    nrm = rgba[..., :3]
    rot = np.linalg.qr(rng.normal(size=(3, 3)))[0].astype(np.float32)
    np.testing.assert_allclose(decode.decode_normal(nrm, rot), native.decode_normal(nrm, rot),
                               atol=SAMPLE_ATOL)
    c2ws = _orbit(2)
    ixts = np.stack([jcam.fov_to_ixt(np.array([0.69, 0.69]), np.array([32, 32]))] * 2)
    for scale in (1.0, 1.0 / 16):
        np.testing.assert_allclose(decode.build_rays_batch(c2ws, ixts, 32, 32, scale),
                                   native.build_rays_batch(c2ws, ixts, 32, 32, scale),
                                   atol=SAMPLE_ATOL)


def test_store_matches_h5_bit_for_bit(stores):
    """write_synthetic_store draws what write_synthetic_h5 draws."""
    import h5py

    h5, npy = stores
    store = NpyStore(npy)
    n = 0
    with h5py.File(h5, "r") as f:
        assert sorted(f.keys()) == store.scenes()
        for scene in f:
            names = [k for k in f[scene] if k != "groups"]
            names += [f"groups/{k}" for k in f[scene]["groups"]]
            for name in names:
                want, got = np.asarray(f[scene][name]), store.read(scene, name)
                assert got.dtype == want.dtype and got.shape == want.shape, name
                np.testing.assert_array_equal(got, want, err_msg=f"{scene}/{name}")
                n += 1
    assert n == N_SCENES * (4 * 12 + sum(range(2, 7)))


@pytest.mark.parametrize("split", ["train", "test"])
def test_samples_match_jax(stores, split):
    """One worker: the augmentation draws (view ids, backgrounds) follow the
    JAX package's order; the port reads the JAX shard and its own store to
    the same bits."""
    h5, npy = stores
    jc, tc = _cfgs(h5, npy, split)
    jds = JaxSyntheticDataset(jc)
    tds = SyntheticDataset(tc)
    tds_h5 = SyntheticDataset(dataclasses.replace(tc, data_root=h5))
    assert isinstance(tds_h5.store, H5Store) and isinstance(tds.store, NpyStore)
    assert len(tds) == len(jds) == (10 if split == "train" else 2)
    for i in range(len(jds)):
        want, got, got_h5 = jds[i], tds[i], tds_h5[i]
        assert got["meta"] == want["meta"] == got_h5["meta"]
        assert set(got) == set(want)
        for k in want:
            if k == "meta":
                continue
            a, b = np.asarray(got[k]), np.asarray(want[k])
            assert a.dtype == b.dtype and a.shape == b.shape, k
            np.testing.assert_array_equal(a, np.asarray(got_h5[k]), err_msg=k)
            if a.dtype.kind in "ui" or k in ("bg_color", "tar_msk"):
                np.testing.assert_array_equal(a, b, err_msg=k)
            else:
                np.testing.assert_allclose(a, b, atol=SAMPLE_ATOL, rtol=0, err_msg=k)
    if split == "train":   # the backgrounds were drawn, not all white
        assert {float(v) for i in range(len(tds)) for v in tds[i]["bg_color"][2:, 0]} \
            > {1.0}


@pytest.mark.parametrize("splits", [False, True])
def test_h5_to_store(stores, tmp_path, splits):
    """`python -m lara_tpu_torch.tools.h5_to_store` on the JAX package's
    shard (and on a copy with a `splits/test` list of variable-length
    strings): every array reads back as `H5Store` reads it, bit for bit,
    and `GObjaverseDataset` serves the same samples from either store, on
    the eval split and on the train split with one seeded generator each."""
    import shutil

    import h5py

    h5 = stores[0]
    if splits:
        h5 = str(shutil.copy(h5, tmp_path / "with_splits.h5"))
        with h5py.File(h5, "a") as f:
            f.create_dataset("splits/test", data=["scene_0007", "scene_0003"],
                             dtype=h5py.string_dtype())
    out = str(tmp_path / "store")
    h5_to_store.main([h5, out])
    src, dst = H5Store(h5), NpyStore(out)
    assert isinstance(open_store(out), NpyStore) and dst.scenes() == src.scenes()
    names = []
    with h5py.File(h5, "r") as f:
        f.visititems(lambda name, obj: names.append(name)
                     if isinstance(obj, h5py.Dataset) else None)
    assert len(names) == N_SCENES * (4 * 12 + sum(range(2, 7))) + splits
    for name in names:
        scene, key = name.split("/", 1)
        want, got = src.read(scene, key), dst.read(scene, key)
        if want.dtype.kind == "O":                 # strings: fixed-length bytes
            assert got.dtype.kind == "S"
            want, got = want.astype(str), got.astype(str)
        assert got.dtype == want.dtype and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    with pytest.raises(FileExistsError):
        h5_to_store.convert(h5, out)

    for split in ("test", "train"):
        cfg = DatasetConfig(dataset_name="gobjaverse", data_root=h5, split=split,
                            img_size=(64, 64), n_group=2, n_scenes=N_SCENES)
        a = GObjaverseDataset(cfg, rng=np.random.default_rng(3))
        b = GObjaverseDataset(dataclasses.replace(cfg, data_root=out),
                              rng=np.random.default_rng(3))
        assert list(b.scenes_name) == list(a.scenes_name)
        if splits:
            assert list(a.scenes_name) == ["scene_0007", "scene_0003"]
        for i in range(2):
            want, got = a[i], b[i]
            assert got["meta"] == want["meta"] and set(got) == set(want)
            for k in want:
                if k != "meta":
                    np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_dataset_writes_its_store_on_first_use(tmp_path):
    cfg = DatasetConfig(dataset_name="synthetic", data_root=str(tmp_path / "a" / "store"),
                        img_size=(32, 32), n_group=2, n_scenes=2)
    ds = get_dataset("synthetic")(cfg)
    assert isinstance(ds.store, NpyStore) and len(ds.store.scenes()) == 4   # at least 4
    assert ds[0]["tar_rgb"].shape == (4, 32, 32, 3)
    assert not list(tmp_path.glob("a/*.tmp*"))
    with pytest.raises(FileNotFoundError):
        open_store(str(tmp_path / "missing"))


def test_augmentation_draws_stay_whole_under_threads(stores, monkeypatch):
    """Eight threads draw samples of one scene at once: under the lock each
    sample's draws are contiguous in the generator's stream, so the set of
    samples drawn equals a serial run's, whatever the interleaving."""
    _, npy = stores
    _, tc = _cfgs(npy, npy, "train", n_group=4)
    serial = SyntheticDataset(tc)
    want = sorted(repr(serial._draw("scene_0001")) for _ in range(64))
    ds = SyntheticDataset(tc)
    got, lock = [], threading.Lock()

    def work():
        for _ in range(8):
            d = repr(ds._draw("scene_0001"))
            with lock:
                got.append(d)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert sorted(got) == want


def test_loader_order_matches_jax(stores):
    """Shuffled batches over two epochs (default_rng((seed, epoch))), then
    the unshuffled test split, with the JAX loader's scenes and arrays."""
    h5, npy = stores
    for split, shuffle in (("train", True), ("test", False)):
        jc, tc = _cfgs(h5, npy, split)
        jl = JaxDataLoader(JaxSyntheticDataset(jc), 2, shuffle=shuffle, num_workers=0, seed=3)
        tl = DataLoader(SyntheticDataset(tc), 2, shuffle=shuffle, num_workers=1, seed=3)
        assert len(tl) == len(jl)
        for epoch in (0, 1):
            jl.set_epoch(epoch)
            tl.set_epoch(epoch)
            pairs = list(zip(jl, tl))
            assert len(pairs) == len(jl)
            for want, got in pairs:
                assert [m["scene"] for m in got["meta"]] == [m["scene"] for m in want["meta"]]
                assert [m["tar_view"] for m in got["meta"]] == \
                    [m["tar_view"] for m in want["meta"]]
                np.testing.assert_allclose(got["tar_rgb"], want["tar_rgb"], atol=SAMPLE_ATOL)
                np.testing.assert_array_equal(got["bg_color"], want["bg_color"])


def test_loader_early_exit_stops_its_worker(stores):
    """Leaving an epoch after one batch (limit_train_batches < 1) stops
    and drains the worker thread."""
    _, npy = stores
    _, tc = _cfgs(npy, npy, "train")
    loader = DataLoader(SyntheticDataset(tc), 2, shuffle=True, num_workers=1, prefetch=1)
    before = threading.active_count()
    it = iter(loader)
    next(it)
    it.close()
    for _ in range(100):
        if threading.active_count() <= before:
            break
        threading.Event().wait(0.05)
    assert threading.active_count() <= before


def test_device_prefetch_order(stores):
    _, npy = stores
    _, tc = _cfgs(npy, npy, "test")
    loader = DataLoader(SyntheticDataset(tc), 1, num_workers=0)
    host = list(loader)
    dev = list(device_prefetch(iter(loader), "cpu"))
    assert len(dev) == len(host) == 2
    for h, d in zip(host, dev):
        assert d["meta"] == h["meta"]
        for k, v in h.items():
            if k != "meta":
                assert isinstance(d[k], torch.Tensor)
                np.testing.assert_array_equal(d[k].numpy(), v)


def test_registry():
    for name in ("synthetic", "gobjeverse", "gobjaverse", "GSO", "instant3d", "mipnerf360"):
        assert get_dataset(name) is not None
    # every name of the JAX package's registry, mvgen (the weight-free
    # front end over an injected generator) included
    assert set(dataset_dict) == set(jax_dataset_dict)
    assert get_dataset("mvgen") is MVGenDataset
    with pytest.raises(KeyError, match="unknown dataset 'no_such_dataset'"):
        get_dataset("no_such_dataset")


def test_vis_panels_match_jax():
    rng = np.random.default_rng(2)
    b, n, h, w = 2, 3, 8, 12
    out = {"image": rng.uniform(size=(b, n, h, w, 3)),
           "depth": rng.uniform(0, 2, size=(b, n, h, w, 1)) * (rng.uniform(size=(b, n, h, w, 1)) > 0.2),
           "rend_normal": rng.uniform(-1, 1, size=(b, n, h, w, 3)),
           "image_fine": rng.uniform(size=(b, n, h, w, 3))}
    batch = {"tar_rgb": rng.uniform(size=(b, n, h, w, 3))}
    want, got = jax_vis_images(out, batch), vis_images(out, batch)
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        tol = 1.0 / 255 + 1e-6 if k.startswith("depth") else 0.0
        np.testing.assert_allclose(got[k], want[k], atol=tol, err_msg=k)


@pytest.mark.parametrize("shape", [(5, 7, 3), (4, 9), (3, 3, 4)])
def test_png_writer_decodes(shape):
    """The zlib PNG writer's bytes decode (zlib + the filter-0 rows) to the
    image, and a float image is read as [0, 1]."""
    import struct
    import zlib

    a = np.random.default_rng(3).integers(0, 256, size=shape).astype(np.uint8)
    data = png_bytes(a)
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    w, h = struct.unpack(">II", data[16:24])
    idat = data.index(b"IDAT")
    n = struct.unpack(">I", data[idat - 4:idat])[0]
    raw = np.frombuffer(zlib.decompress(data[idat + 4:idat + 4 + n]), np.uint8)
    rows = raw.reshape(h, -1)
    assert (w, h) == (shape[1], shape[0]) and not rows[:, 0].any()
    np.testing.assert_array_equal(rows[:, 1:].reshape(a.shape), a)
    assert png_bytes(a.astype(np.float32) / 255.0) == data
