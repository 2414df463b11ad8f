"""Shaded mesh turntable of an `.obj`, the counterpart of the JAX package's
`tools/mesh_render.py` (a CPU stand-in for the reference's Mitsuba turntable,
tools/meshRender.py:9-51 + configs/render/scene.xml):

    python -m lara_tpu_torch.tools.mesh_render MESH.obj [--out mesh_video.mp4]
        [--frames 16] [--size 256]

Deferred pipeline in NumPy, the JAX tool's operations in the same order,
so its frames are that tool's bit for bit:
  1. rasterize perspective-correct G-buffers — depth, smooth vertex
     normal, albedo (vertex colours when the OBJ has them) — with a
     per-pixel z-buffer, one triangle at a time;
  2. shade: Blinn-Phong with a key, a cool fill and a rim light, plus
     screen-space ambient occlusion from the depth buffer and a white
     environment.

The cameras are `eval/video_path.py:uni_mesh_path` (3 elevations × N). The
frames become an mp4 where OpenCV imports and opens a writer, else PNG
frames `<out without extension>/frame_%04d.png` (the GPU machine has no
OpenCV).
"""

from __future__ import annotations

import argparse
import time

import numpy as np


def load_obj(path: str):
    """Vertices, faces, optional per-vertex colors (`v x y z r g b` rows —
    the format `eval/tsdf.py:save_obj` writes)."""
    verts, faces, colors = [], [], []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                vals = [float(x) for x in line.split()[1:]]
                verts.append(vals[:3])
                if len(vals) >= 6:
                    colors.append(vals[3:6])
            elif line.startswith("f "):
                faces.append([int(t.split("/")[0]) - 1 for t in line.split()[1:4]])
    v = np.array(verts, np.float32)
    c = np.array(colors, np.float32) if len(colors) == len(verts) else None
    return v, np.array(faces, np.int64), c


def vertex_normals(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Area-weighted smooth vertex normals."""
    v0, v1, v2 = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    fn = np.cross(v1 - v0, v2 - v0)           # area-weighted
    vn = np.zeros_like(verts)
    for i in range(3):
        np.add.at(vn, faces[:, i], fn)
    return vn / np.maximum(np.linalg.norm(vn, axis=-1, keepdims=True), 1e-12)


def rasterize_gbuffer(verts, faces, vnormals, albedo, c2w, ixt, H, W):
    """Per-pixel perspective-correct z/normal/albedo buffers."""
    w2c = np.linalg.inv(c2w)
    cam = verts @ w2c[:3, :3].T + w2c[:3, 3]
    z = cam[:, 2]
    inv_z = 1.0 / np.maximum(z, 1e-6)
    px = ixt[0, 0] * cam[:, 0] * inv_z + ixt[0, 2]
    py = ixt[1, 1] * cam[:, 1] * inv_z + ixt[1, 2]

    zbuf = np.full((H, W), np.inf, np.float32)
    nbuf = np.zeros((H, W, 3), np.float32)
    abuf = np.zeros((H, W, 3), np.float32)

    tri_z = np.stack([z[faces[:, i]] for i in range(3)], 1)
    front = tri_z.min(1) > 1e-4
    for t in np.nonzero(front)[0]:
        i0, i1, i2 = faces[t]
        xs = np.array([px[i0], px[i1], px[i2]])
        ys = np.array([py[i0], py[i1], py[i2]])
        x0, x1 = int(max(np.floor(xs.min()), 0)), int(min(np.ceil(xs.max()), W - 1)) + 1
        y0, y1 = int(max(np.floor(ys.min()), 0)), int(min(np.ceil(ys.max()), H - 1)) + 1
        if x0 >= x1 or y0 >= y1:
            continue
        d = (ys[1] - ys[2]) * (xs[0] - xs[2]) + (xs[2] - xs[1]) * (ys[0] - ys[2])
        if abs(d) < 1e-12:
            continue
        gy, gx = np.mgrid[y0:y1, x0:x1]
        gx = gx + 0.5
        gy = gy + 0.5
        a = ((ys[1] - ys[2]) * (gx - xs[2]) + (xs[2] - xs[1]) * (gy - ys[2])) / d
        b = ((ys[2] - ys[0]) * (gx - xs[2]) + (xs[0] - xs[2]) * (gy - ys[2])) / d
        c = 1.0 - a - b
        inside = (a >= 0) & (b >= 0) & (c >= 0)
        if not inside.any():
            continue
        # perspective-correct: interpolate 1/z and attr/z
        izs = np.array([1.0 / max(z[i0], 1e-6), 1.0 / max(z[i1], 1e-6),
                        1.0 / max(z[i2], 1e-6)])
        iz = a * izs[0] + b * izs[1] + c * izs[2]
        zpix = 1.0 / np.maximum(iz, 1e-12)
        win = zbuf[y0:y1, x0:x1]
        upd = inside & (zpix < win)
        if not upd.any():
            continue
        wgt = np.stack([a * izs[0], b * izs[1], c * izs[2]], -1) * zpix[..., None]
        n = (wgt[..., 0:1] * vnormals[i0] + wgt[..., 1:2] * vnormals[i1]
             + wgt[..., 2:3] * vnormals[i2])
        al = (wgt[..., 0:1] * albedo[i0] + wgt[..., 1:2] * albedo[i1]
              + wgt[..., 2:3] * albedo[i2])
        win[upd] = zpix[upd]
        nbuf[y0:y1, x0:x1][upd] = n[upd]
        abuf[y0:y1, x0:x1][upd] = al[upd]
    return zbuf, nbuf, abuf


def ssao(zbuf: np.ndarray, radius_px: int = 8, samples: int = 12,
         strength: float = 0.9) -> np.ndarray:
    """Screen-space ambient occlusion: fraction of ring samples whose depth
    is in front of the center (contact/crevice darkening)."""
    H, W = zbuf.shape
    hit = np.isfinite(zbuf)
    z = np.where(hit, zbuf, 0.0)
    occ = np.zeros((H, W), np.float32)
    rng = np.random.default_rng(0)
    total = 0
    for k in range(samples):
        ang = 2 * np.pi * (k + rng.uniform(0, 1)) / samples
        r = radius_px * (0.3 + 0.7 * rng.uniform(0, 1))
        dx, dy = int(round(r * np.cos(ang))), int(round(r * np.sin(ang)))
        if dx == 0 and dy == 0:
            continue
        sh = np.roll(np.roll(z, dy, 0), dx, 1)
        sh_hit = np.roll(np.roll(hit, dy, 0), dx, 1)
        closer = sh_hit & hit & (sh < z - 0.005) & (z - sh < 0.15)
        occ += closer.astype(np.float32)
        total += 1
    ao = 1.0 - strength * occ / max(total, 1)
    # slight blur to hide sampling noise
    ao = (ao + np.roll(ao, 1, 0) + np.roll(ao, -1, 0)
          + np.roll(ao, 1, 1) + np.roll(ao, -1, 1)) / 5.0
    return np.clip(ao, 0.0, 1.0)


# studio rig: key / cool fill / rim, camera space (z forward)
_LIGHTS = (
    ((-0.45, -0.6, -0.66), (1.0, 0.98, 0.92), 0.9),   # key, warm, above-left
    ((0.7, 0.2, -0.7), (0.65, 0.72, 0.85), 0.35),     # fill, cool, right
    ((0.0, 0.55, 0.84), (1.0, 1.0, 1.0), 0.25),       # rim, from behind
)


def shade(zbuf, nbuf, abuf, ambient: float = 0.30,
          spec: float = 0.35, shininess: float = 24.0,
          bg: float = 1.0) -> np.ndarray:
    """Blinn-Phong + SSAO deferred shading (camera-space buffers)."""
    hit = np.isfinite(zbuf)
    n = nbuf / np.maximum(np.linalg.norm(nbuf, axis=-1, keepdims=True), 1e-12)
    # flip normals toward the camera (view dir ≈ -z)
    n = np.where(n[..., 2:3] > 0, -n, n)
    view = np.array([0.0, 0.0, -1.0])
    ao = ssao(zbuf)

    col = np.zeros_like(abuf)
    col += ambient * ao[..., None] * abuf
    for ldir, lcol, lint in _LIGHTS:
        l = -np.asarray(ldir, np.float32)
        l = l / np.linalg.norm(l)
        ndl = np.clip(np.sum(n * l, -1, keepdims=True), 0.0, 1.0)
        h = l + view
        h = h / np.linalg.norm(h)
        ndh = np.clip(np.sum(n * h, -1, keepdims=True), 0.0, 1.0)
        contrib = (abuf * ndl + spec * ndh ** shininess) * np.asarray(lcol) * lint
        col += contrib * (0.4 + 0.6 * ao[..., None])
    out = np.where(hit[..., None], np.clip(col, 0.0, 1.0), bg)
    return out.astype(np.float32)


def render_mesh_view(verts, faces, c2w, ixt, H, W, colors=None,
                     vnormals=None):
    """One shaded turntable frame. `colors` [V,3] vertex albedo (default
    neutral studio gray); pass precomputed `vnormals` to amortize."""
    if vnormals is None:
        vnormals = vertex_normals(verts, faces)
    albedo = colors if colors is not None else np.full_like(verts, 0.78)
    # normals into camera space for shading
    w2c = np.linalg.inv(c2w)
    zb, nb, ab = rasterize_gbuffer(verts, faces, vnormals @ w2c[:3, :3].T,
                                   albedo, c2w, ixt, H, W)
    return shade(zb, nb, ab)


def main(argv=None) -> str:
    from lara_tpu_torch.eval.render_artifacts import write_video
    from lara_tpu_torch.eval.video_path import uni_mesh_path

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mesh")
    ap.add_argument("--out", default="mesh_video.mp4")
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--frames", type=int, default=16)
    args = ap.parse_args(argv)

    verts, faces, colors = load_obj(args.mesh)
    vn = vertex_normals(verts, faces)
    cams = uni_mesh_path(args.frames, "gobjeverse", (args.size, args.size))
    t0 = time.perf_counter()
    frames = [(render_mesh_view(verts, faces, cam.c2w, cam.ixt, args.size, args.size,
                                colors, vn) * 255).astype(np.uint8) for cam in cams]
    per_frame = (time.perf_counter() - t0) / len(frames)
    out = write_video(args.out, frames, fps=15)
    print(f"-> {out} ({len(frames)} frames of {args.size}², {len(faces)} triangles, "
          f"{per_frame:.3f} s per frame)")
    return out


if __name__ == "__main__":
    main()
