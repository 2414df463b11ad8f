"""Multi-view generation front end: a single image (or a text prompt) →
four posed views → the standard LaRa batch. The counterpart of
`lara_tpu/data/mvgen.py` (dataLoader/mvgen.py of the reference).

The diffusion models (zero123plus through diffusers hub pipelines, SV3D
through the sgm stack) are generator backends behind one interface,
`MultiViewGenerator.generate(image | prompt) -> (views [4, H, W, 3], c2ws
[4, 4, 4], fxfycxcy [4])`; a caller injects the backend as `pipeline`.
Without one, zero123plus loads diffusers and its hub weights as the JAX
module does (`ImportError` where diffusers is absent) and sv3d raises. The
camera rigs, grid slicing, matting and batch assembly are the JAX module's:

- the INTER_AREA resize is `data/image_io.py:resize` (OpenCV's float32
  result within 1e-6; zero123plus tiles of 320² are scaled up to 512² by
  OpenCV's linear filter at area-mode positions, SV3D's 576² frames down by
  overlap weights), on float32 views;
- the matte's 4-connected labelling of background-like pixels is
  `scipy.ndimage.label` with the cross structuring element in place of
  `cv2.connectedComponents(..., connectivity=4)`: only which pixels are
  4-connected to the border matters, so the alpha is the same, bit for bit;
- the conditioning image is read by `data/image_io.py:read_png` (imageio's
  reading, bit for bit); the port has no JPEG decoder, so a `.jpg` /
  `.jpeg` raises with its name.

Camera rigs (dataLoader/mvgen.py:219,259,295 — poses are (pitch°, yaw°) at
radius 2.7 looking at the origin, world-up −z, normalized intrinsics
fx = 0.5/tan(fov/2)):
  zero123plus-v1.1  [(30,225+30), (30,225+150), (30,225+270), (-20,225+330)], fov 50
  zero123plus-v1.2  [(20,225+30), (20,225+150), (20,225+270), (-10,225+330)], fov 30
  sv3d              [(20,225), (20,225+90), (20,225+180), (20,225+270)], fov 33.8
"""

from __future__ import annotations

import glob
import os
from typing import Callable, Optional, Tuple

import numpy as np

from lara_tpu_torch.config import DatasetConfig
from lara_tpu_torch.data.image_io import INTER_AREA, read_png, resize
from lara_tpu_torch.utils.camera import build_rays_np, canonicalize_cameras_np, intrinsic_to_fov

RIGS = {
    "zero123plus-v1.1": (2.7, [(30, 255), (30, 375), (30, 495), (-20, 555)], 50.0),
    "zero123plus-v1.2": (2.7, [(20, 255), (20, 375), (20, 495), (-10, 555)], 30.0),
    "sv3d": (2.7, [(20, 225), (20, 315), (20, 405), (20, 495)], 33.8),
}

# the 6-image 3×2 zero123plus grid is sliced and views [0,2,4,5] are kept
# (dataLoader/mvgen.py:203,245); sv3d renders a 21-frame orbit of which
# frames [0,4,8,12] (azimuth 0/90/180/270 at elevation 20) are kept (:286)
ZERO123_SUBSET = [0, 2, 4, 5]
SV3D_FRAMES = [0, 4, 8, 12]
SV3D_AZIMUTHS = [0, 10, 30, 50, 90, 110, 130, 150, 180, 200, 220, 240, 270,
                 280, 290, 300, 310, 320, 330, 340, 350]

# 4-connectivity for the matte's background components
_CROSS = np.array([[0, 1, 0], [1, 1, 1], [0, 1, 0]], bool)


def generate_input_camera(r: float, poses, fov: float = 50.0):
    """Orbit rig: poses [(pitch_deg, yaw_deg)] at radius r looking at the
    origin with world-up -z (dataLoader/mvgen.py:303-336).
    Returns (c2ws [V,4,4], fxfycxcy [4] normalized intrinsics)."""
    poses = np.deg2rad(np.asarray(poses, np.float32))
    pitch, yaw = poses[:, 0], poses[:, 1]
    z = r * np.sin(pitch)
    x = r * np.cos(pitch) * np.cos(yaw)
    y = r * np.cos(pitch) * np.sin(yaw)
    cam_pos = np.stack([x, y, z], -1)

    def norm(v):
        return v / np.linalg.norm(v, axis=-1, keepdims=True)

    forward = norm(-cam_pos)
    up = np.broadcast_to(np.array([0.0, 0.0, -1.0], np.float32), forward.shape)
    left = norm(np.cross(up, forward))
    up = norm(np.cross(forward, left))
    rot = np.stack((left, up, forward), axis=-1)

    c2ws = np.broadcast_to(np.eye(4, dtype=np.float32), (len(poses), 4, 4)).copy()
    c2ws[:, :3, :3] = rot
    c2ws[:, :3, 3] = cam_pos
    fx = 0.5 / np.tan(np.deg2rad(fov / 2))
    return c2ws.astype(np.float32), np.array([fx, fx, 0.5, 0.5], np.float32)


def rig_cameras(backend: str):
    """(c2ws [4,4,4], fxfycxcy [4]) for a generator backend's fixed rig."""
    r, poses, fov = RIGS[backend]
    return generate_input_camera(r, poses, fov=fov)


def slice_grid(img: np.ndarray, rows: int, cols: int):
    """Split a diffusion output grid into tiles row-major
    (dataLoader/mvgen.py:196-201: the 3×2 zero123plus grid → 6 views)."""
    h, w = img.shape[0] // rows, img.shape[1] // cols
    return [img[r * h:(r + 1) * h, c * w:(c + 1) * w]
            for r in range(rows) for c in range(cols)]


def pad_to_square(img: np.ndarray, fill: float = 1.0) -> np.ndarray:
    """Center-pad to square (dataLoader/mvgen.py pad_image_to_square)."""
    h, w = img.shape[:2]
    s = max(h, w)
    out = np.full((s, s, img.shape[2]), fill, img.dtype)
    y, x = (s - h) // 2, (s - w) // 2
    out[y:y + h, x:x + w] = img
    return out


class MultiViewGenerator:
    """Backend-pluggable image/text → posed multi-view generator.

    `pipeline` is the model invocation:
      - zero123plus backends: pipeline(image [H,W,3] float) -> grid
        [3H', 2W', 3] float in [0,1]
      - sv3d: pipeline(image) -> video frames [21, H, W, 3] float in [0,1]
      - text→3D: `text_to_image` (prompt -> image) chains into the image
        path (the reference's text path raises, dataLoader/mvgen.py:106).
    Views are resized in float32.
    """

    def __init__(self, backend: str = "zero123plus-v1.1",
                 pipeline: Optional[Callable] = None,
                 text_to_image: Optional[Callable] = None):
        if backend not in RIGS:
            raise ValueError(f"unknown generator backend {backend!r}; "
                             f"choose from {sorted(RIGS)}")
        self.backend = backend
        self._pipe = pipeline
        self._text_to_image = text_to_image

    def _load_pipeline(self):
        """The diffusion backend, where no pipeline was injected: zero123plus
        from the diffusers hub (needs diffusers, Pillow and the weights)."""
        if self.backend.startswith("zero123plus"):
            try:
                import torch
                from diffusers import DiffusionPipeline, EulerAncestralDiscreteScheduler
            except ImportError as e:
                raise ImportError(
                    f"the {self.backend} backend loads its diffusion model through diffusers, "
                    "which is not installed; inject the generator as MultiViewGenerator("
                    "backend, pipeline=fn) or MVGenDataset(cfg, pipeline=fn), fn(image "
                    "[H, W, 3] float) -> a 3×2 grid [3H', 2W', 3] in [0, 1]") from e

            repo = {"zero123plus-v1.1": "sudo-ai/zero123plus-v1.1",
                    "zero123plus-v1.2": "sudo-ai/zero123plus-v1.2"}[self.backend]
            pipe = DiffusionPipeline.from_pretrained(
                repo, custom_pipeline="sudo-ai/zero123plus-pipeline",
                torch_dtype=torch.float32)
            pipe.scheduler = EulerAncestralDiscreteScheduler.from_config(
                pipe.scheduler.config, timestep_spacing="trailing")

            def run(image):
                from PIL import Image

                cond = Image.fromarray((image * 255).astype(np.uint8))
                out = pipe(cond, num_inference_steps=30).images[0]
                return np.asarray(out).astype(np.float32) / 255.0

            return run
        raise RuntimeError(
            "sv3d requires an injected pipeline (image -> [21,H,W,3] orbit "
            "video frames); the sgm diffusion stack is an external provider")

    def generate(self, image: Optional[np.ndarray] = None,
                 prompt: Optional[str] = None, img_size: int = 512,
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Returns (views [4,H,W,3] float in [0,1] white-composited,
        c2ws [4,4,4], fxfycxcy [4] normalized intrinsics)."""
        if image is None:
            if prompt is None:
                raise ValueError("provide an image or a prompt")
            if self._text_to_image is None:
                raise NotImplementedError(
                    "text→3D needs a text_to_image backend (prompt → image); "
                    "the reference's text path was never functional either "
                    "(dataLoader/mvgen.py:106)")
            image = self._text_to_image(prompt)

        image = pad_to_square(image)
        if self._pipe is None:
            self._pipe = self._load_pipeline()

        if self.backend.startswith("zero123plus"):
            tiles = slice_grid(self._pipe(image), 3, 2)
            views = [matte_white(area_resize(tiles[i], img_size)) for i in ZERO123_SUBSET]
        else:  # sv3d
            video = np.asarray(self._pipe(image))
            views = [area_resize(video[i], img_size) for i in SV3D_FRAMES]

        c2ws, fxfycxcy = rig_cameras(self.backend)
        return np.stack(views).astype(np.float32), c2ws, fxfycxcy


def fxfycxcy_to_pixel_ixt(fxfycxcy: np.ndarray, w: int, h: int) -> np.ndarray:
    """Normalized [fx,fy,cx,cy] → pixel intrinsics
    (dataLoader/mvgen.py:113-121)."""
    ixt = np.eye(3, dtype=np.float32)
    ixt[0, 0] = fxfycxcy[0] * w
    ixt[1, 1] = fxfycxcy[1] * h
    ixt[0, 2] = fxfycxcy[2] * w
    ixt[1, 2] = fxfycxcy[3] * h
    return ixt


def area_resize(img: np.ndarray, size: int) -> np.ndarray:
    """`cv2.resize(img, (size, size), interpolation=cv2.INTER_AREA)` in float32."""
    return resize(np.asarray(img, np.float32), (size, size), INTER_AREA)


def estimate_alpha_matte(img: np.ndarray, lo: float = 0.06,
                         hi: float = 0.25) -> np.ndarray:
    """Classical (weight-free) foreground alpha for a generator view.

    Diffusion multi-view outputs place one object on a near-uniform
    background (gray for zero123plus, white/black for sv3d). The matte:
      1. models the background color as the median of the border pixels;
      2. maps color distance to a soft alpha ramp (lo → 0, hi → 1);
      3. keeps only background that is 4-CONNECTED to the image border —
         background-colored pixels enclosed by the object (e.g. a white
         highlight on a white-bg render) stay foreground (alpha 1).

    Returns alpha [H, W, 1] in [0, 1]. Replaces rembg's learned matting
    (dataLoader/mvgen.py:195-208) when it is unavailable; the contract
    (alpha → white composite) is the same.
    """
    from scipy import ndimage

    img = np.asarray(img, np.float32)
    border = np.concatenate([img[0], img[-1], img[:, 0], img[:, -1]], axis=0)
    bg = np.median(border, axis=0)
    dist = np.linalg.norm(img - bg, axis=-1)
    alpha = np.clip((dist - lo) / max(hi - lo, 1e-6), 0.0, 1.0)

    bg_like = dist < (lo + hi) / 2
    labels, _ = ndimage.label(bg_like, structure=_CROSS)      # 0: not background-like
    edge = np.unique(np.concatenate([labels[0], labels[-1], labels[:, 0], labels[:, -1]]))
    hole = bg_like & ~np.isin(labels, edge)
    alpha = np.where(hole, 1.0, alpha)
    return alpha[..., None].astype(np.float32)


def matte_white(img: np.ndarray) -> np.ndarray:
    """Background matting → white composite (dataLoader/mvgen.py:195-208).
    Uses rembg's learned segmenter when importable; otherwise the classical
    border-seeded `estimate_alpha_matte` — same alpha→white contract."""
    try:
        import rembg

        rgba = rembg.remove((img * 255).astype(np.uint8))
        rgba = rgba.astype(np.float32) / 255.0
        return rgba[..., :3] * rgba[..., 3:] + (1 - rgba[..., 3:])
    except Exception:
        a = estimate_alpha_matte(img)
        return img * a + (1.0 - a)


def build_mvgen_batch(views: np.ndarray, c2ws: np.ndarray,
                      fxfycxcy: np.ndarray,
                      scene_rescale: float = 1.7) -> dict:
    """Assemble the standard LaRa batch from generated views
    (dataLoader/mvgen.py:109-157: /1.7 rescale, first-view canonicalization,
    white bg, near/far r∓0.8, full+1/16 ray grids)."""
    V, H, W, _ = views.shape
    ixt = fxfycxcy_to_pixel_ixt(fxfycxcy, W, H)
    ixts = np.tile(ixt[None], (V, 1, 1)).astype(np.float32)
    c2ws = c2ws.copy()
    c2ws[:, :3, 3] /= scene_rescale
    w2cs = np.linalg.inv(c2ws)
    r = np.linalg.norm(c2ws[0, :3, 3])
    c2ws, w2cs, transform_mats = canonicalize_cameras_np(c2ws, w2cs)
    fovx, fovy = intrinsic_to_fov(ixts[0], w=W, h=H)
    return {
        "tar_rgb": views.astype(np.float32),
        "tar_c2w": c2ws, "tar_w2c": w2cs, "tar_ixt": ixts,
        "bg_color": np.ones((V, 3), np.float32),
        "near_far": np.array([r - 0.8, r + 0.8], np.float32),
        "fovx": np.float32(fovx), "fovy": np.float32(fovy),
        "transform_mats": transform_mats,
        "meta": {"scene": "mvgen", "tar_h": H, "tar_w": W},
        "tar_rays": build_rays_np(c2ws, ixts, H, W, 1.0),
        "tar_rays_down": build_rays_np(c2ws, ixts, H, W, 1.0 / 16),
    }


class MVGenDataset:
    """One generated scene per input image or prompt
    (dataLoader/mvgen.py:25-157). Without `image_paths` and `prompts` the
    images are `cfg.data_root`'s `*.png`, `*.jpg` and `*.jpeg` in sorted
    order; `meta["scene"]` is the scene's index."""

    def __init__(self, cfg: DatasetConfig, image_paths=None, prompts=None,
                 backend: Optional[str] = None, pipeline=None,
                 text_to_image=None, rng=None):
        self.cfg = cfg
        backend = backend or getattr(cfg, "generator_type", None) or "zero123plus-v1.1"
        self.generator = MultiViewGenerator(backend, pipeline=pipeline,
                                            text_to_image=text_to_image)
        if image_paths is None and prompts is None:
            image_paths = sorted(
                glob.glob(os.path.join(cfg.data_root, "*.png"))
                + glob.glob(os.path.join(cfg.data_root, "*.jpg"))
                + glob.glob(os.path.join(cfg.data_root, "*.jpeg")))
        self.image_paths = image_paths or []
        self.prompts = prompts or []

    def __len__(self):
        return len(self.image_paths) + len(self.prompts)

    def __getitem__(self, index: int) -> dict:
        size = int(self.cfg.img_size[0])
        if index < len(self.image_paths):
            img = read_image(self.image_paths[index])
            views, c2ws, fxfycxcy = self.generator.generate(image=img, img_size=size)
        else:
            prompt = self.prompts[index - len(self.image_paths)]
            views, c2ws, fxfycxcy = self.generator.generate(prompt=prompt, img_size=size)
        batch = build_mvgen_batch(views, c2ws, fxfycxcy)
        batch["meta"]["scene"] = str(index)
        return batch


def read_image(path: str) -> np.ndarray:
    """A conditioning image as float in [0, 1], RGBA composited over white."""
    if os.path.splitext(path)[1].lower() in (".jpg", ".jpeg"):
        raise ValueError(f"{path}: lara_tpu_torch reads PNG conditioning images only "
                         "(it has no JPEG decoder); convert the file to PNG")
    img = read_png(path).astype(np.float32) / 255.0
    if img.shape[-1] == 4:
        img = img[..., :3] * img[..., 3:] + (1 - img[..., 3:])
    return img
