"""gobjaverse dataset, the counterpart of `lara_tpu/data/gobjverse.py`
(dataLoader/gobjverse.py of the reference).

Scene schema (tools/prepare_dataset_objaverse.py:133-152): per scene
`image_{i}` [H,W,4] u8, `normal_{i}` [H,W,3] u8, `c2w_{i}` [4,4] f32,
`fov_{i}` [2] f32 and KMeans view clusters `groups/groups_{n}_{i}` for n in
2..6. Two stores hold it: `NpyStore`, a directory of `.npy` files per scene
(what `data/synthetic.py` writes; needs nothing beyond NumPy), and
`H5Store`, the JAX package's HDF5 shard, read where h5py is importable.

A sample follows the §1 L2 batch contract: N = 2·n_group views (first half
inputs, second half supervision), canonicalised so view 0 sits at distance
r on −z, background augmentation {0, 0.5, 1} on the supervision views in
training.
"""

from __future__ import annotations

import os
import threading

import numpy as np

from lara_tpu_torch.config import DatasetConfig
from lara_tpu_torch.data.decode import build_rays_batch, composite_rgba, decode_normal
from lara_tpu_torch.utils.camera import canonicalize_cameras_np, fov_to_ixt


class NpyStore:
    """A directory with one subdirectory per scene and one `.npy` file per
    array (`groups/groups_4_0` is `<scene>/groups/groups_4_0.npy`)."""

    def __init__(self, root: str):
        self.root = root

    def scenes(self):
        return sorted(e.name for e in os.scandir(self.root)
                      if e.is_dir() and not e.name.startswith("."))

    def read(self, scene: str, name: str) -> np.ndarray:
        return np.load(os.path.join(self.root, scene, name + ".npy"))


class H5Store:
    """The JAX package's HDF5 shard. h5py is imported on first use, and each
    thread opens its own handle (libhdf5 is not thread-safe; a handle
    shared by the threaded loader segfaulted, lara_tpu/data/gobjverse.py:
    30-35); reads are serialised by one lock, as the JAX package's are."""

    _LOCK = threading.RLock()

    def __init__(self, path: str):
        self.path = path
        self._local = threading.local()

    def _file(self):
        f = getattr(self._local, "f", None)
        if f is None:
            try:
                import h5py
            except ImportError as e:
                raise ImportError(f"{self.path} is an HDF5 shard and h5py is not installed; "
                                  "use an .npy scene store (lara_tpu_torch/data/synthetic.py)"
                                  ) from e
            f = self._local.f = h5py.File(self.path, "r")
        return f

    def scenes(self):
        with self._LOCK:
            return sorted(self._file().keys())

    def read(self, scene: str, name: str) -> np.ndarray:
        with self._LOCK:
            return np.asarray(self._file()[scene][name])


def open_store(path: str):
    """The store at `path`: a directory is an NpyStore, a file an H5Store."""
    if os.path.isdir(path):
        return NpyStore(path)
    if os.path.isfile(path):
        return H5Store(path)
    raise FileNotFoundError(f"no scene store at {path}")


class GObjaverseDataset:
    def __init__(self, cfg: DatasetConfig, rng: np.random.Generator | None = None):
        self.cfg = cfg
        self.split = cfg.split
        self.img_size = np.array(cfg.img_size)
        self.n_group = cfg.n_group
        self.store = open_store(cfg.data_root)
        scenes_name = np.array(self.store.scenes())
        if "splits" in scenes_name:
            self.scenes_name = self.store.read("splits", "test")[:].astype(str)
        else:
            i_test = np.arange(len(scenes_name))[::10][: cfg.n_scenes]
            i_train = np.array(
                [i for i in np.arange(len(scenes_name)) if i not in i_test]
            )[: cfg.n_scenes]
            self.scenes_name = (
                scenes_name[i_train] if self.split == "train" else scenes_name[i_test]
            )
        # the augmentation generator: one per dataset, drawn in the JAX
        # package's order, under a lock so loader threads take whole scenes
        self.rng = rng or np.random.default_rng(0)
        self._rng_lock = threading.Lock()

    def __len__(self):
        return len(self.scenes_name)

    def _draw(self, scene: str):
        """(view ids, background colours) of one sample. Group-based view
        sampling (dataLoader/gobjverse.py:45-53): in training one random
        member of each of the n_group clusters for the inputs and again for
        the supervision, each supervision view on a random background; at
        eval the clusters' representatives on white."""
        def group(n, i):
            return self.store.read(scene, f"groups/groups_{n}_{i}")

        n, train = self.n_group, self.split == "train"
        with self._rng_lock:
            if train and n > 1:
                perm1 = self.rng.permutation(n)
                perm2 = self.rng.permutation(n)
                view_id = ([int(self.rng.choice(group(n, i)[:])) for i in perm1]
                           + [int(self.rng.choice(group(n, i)[:])) for i in perm2])
            elif n == 1:
                view_id = [int(group(4, 0)[0])] + [int(group(4, i)[-1]) for i in range(4)]
            else:
                view_id = ([int(group(n, i)[0]) for i in range(n)]
                           + [int(group(4, i)[-1]) for i in range(4)])
            bgs = [np.ones(3, np.float32) if not train or i < n
                   else np.ones(3, np.float32) * self.rng.choice([0.0, 0.5, 1.0])
                   for i in range(len(view_id))]
        return view_id, bgs

    def skip(self, index: int) -> None:
        """Draw sample `index`'s augmentation without loading it, so the
        generator is where loading it would leave it (a data-parallel rank
        passing over another dp index's sample, `data/loader.py`)."""
        self._draw(str(self.scenes_name[index]))

    def __getitem__(self, index: int) -> dict:
        scene = str(self.scenes_name[index])
        view_id, bg_colors = self._draw(scene)

        imgs, nrms, msks, c2ws, w2cs, ixts = [], [], [], [], [], []
        for idx, bg in zip(view_id, bg_colors):
            img, msk = composite_rgba(self.store.read(scene, f"image_{idx}"), bg)
            imgs.append(img)
            msks.append(msk)
            if self.cfg.load_normal:
                nrms.append(self.store.read(scene, f"normal_{idx}"))
            c2w = np.asarray(self.store.read(scene, f"c2w_{idx}"), np.float32)
            fov = np.asarray(self.store.read(scene, f"fov_{idx}"), np.float32)
            c2ws.append(c2w)
            w2cs.append(np.linalg.inv(c2w))
            ixts.append(fov_to_ixt(fov, self.img_size))

        tar_c2ws, tar_w2cs = np.stack(c2ws), np.stack(w2cs)
        tar_ixts = np.stack(ixts)
        r = np.linalg.norm(tar_c2ws[0, :3, 3])
        tar_c2ws, tar_w2cs, transform_mats = canonicalize_cameras_np(tar_c2ws, tar_w2cs)

        H, W = int(self.img_size[1]), int(self.img_size[0])
        fov0 = np.asarray(self.store.read(scene, "fov_0"), np.float32)
        ret = {
            "fovx": np.float32(fov0[0]),
            "fovy": np.float32(fov0[1]),
            "tar_c2w": tar_c2ws,
            "tar_w2c": tar_w2cs,
            "tar_ixt": tar_ixts,
            "tar_rgb": np.stack(imgs),
            "tar_msk": np.stack(msks),
            "transform_mats": transform_mats,
            "bg_color": np.stack(bg_colors),
            "near_far": np.array([r - 0.8, r + 0.8], np.float32),
            "meta": {"scene": scene, "tar_view": view_id, "tar_h": H, "tar_w": W},
        }
        if self.cfg.load_normal:
            rot = np.ascontiguousarray(transform_mats[0, :3, :3], np.float32)
            ret["tar_nrm"] = np.stack([decode_normal(n, rot) for n in nrms])
        ret["tar_rays"] = build_rays_batch(tar_c2ws, tar_ixts, H, W, 1.0)
        ret["tar_rays_down"] = build_rays_batch(tar_c2ws, tar_ixts, H, W, 1.0 / 16)
        return ret
