"""TSDF fusion + isosurface extraction in pure NumPy, a copy of
`lara_tpu/eval/tsdf.py`.

Replaces Open3D's ScalableTSDFVolume + triangle-mesh pipeline used by the
reference mesh extractor (tools/meshExtractor.py:67-135): depth/color maps
rendered on an orbit are integrated into a dense truncated-SDF grid, the
zero level set is meshed with marching tetrahedra (compact tables, valid
watertight output), and small disconnected clusters are removed via a
scipy connected-components pass.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

# Six-tetrahedra decomposition of a cube (corner indices).
_TETS = np.array([
    [0, 5, 1, 6], [0, 1, 2, 6], [0, 2, 3, 6],
    [0, 3, 7, 6], [0, 7, 4, 6], [0, 4, 5, 6],
], np.int32)
# Cube corner offsets in (x, y, z).
_CORNERS = np.array([
    [0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
    [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1],
], np.int32)


def _tet_case_table():
    """code (4-bit inside mask) → list of triangles, each a list of 3 edges
    (a, b) interpolated between tet-local vertices a (inside-side) and b."""
    table = {}
    for code in range(16):
        inside = [i for i in range(4) if code >> i & 1]
        outside = [i for i in range(4) if not code >> i & 1]
        if len(inside) in (0, 4):
            table[code] = []
        elif len(inside) == 1:
            a = inside[0]
            b, c, d = outside
            table[code] = [[(a, b), (a, c), (a, d)]]
        elif len(inside) == 3:
            a = outside[0]
            b, c, d = inside
            table[code] = [[(b, a), (d, a), (c, a)]]
        else:
            a, b = inside
            c, d = outside
            table[code] = [[(a, c), (a, d), (b, d)], [(a, c), (b, d), (b, c)]]
    return table


class TSDFVolume:
    def __init__(self, aabb: np.ndarray, voxel_size: float, sdf_trunc: float):
        """aabb [2,3]; dense grid covering it at voxel_size spacing."""
        self.aabb = np.asarray(aabb, np.float32)
        self.voxel_size = float(voxel_size)
        self.sdf_trunc = float(sdf_trunc)
        dims = np.ceil((self.aabb[1] - self.aabb[0]) / voxel_size).astype(int) + 1
        self.dims = dims
        xs = [self.aabb[0, i] + np.arange(dims[i]) * voxel_size for i in range(3)]
        gx, gy, gz = np.meshgrid(*xs, indexing="ij")
        self.points = np.stack([gx, gy, gz], -1).reshape(-1, 3).astype(np.float32)
        # float64, the type the JAX package's volume takes at its first
        # integration (its float32 arrays meet the float64 weight there)
        self.tsdf = np.ones(self.points.shape[0], np.float64)
        self.weight = np.zeros(self.points.shape[0], np.float64)
        self.color = np.zeros((self.points.shape[0], 3), np.float64)

    def integrate(self, depth: np.ndarray, color: np.ndarray,
                  ixt: np.ndarray, w2c: np.ndarray, depth_trunc: float = 10.0):
        """depth [H,W] (0 = invalid), color [H,W,3] in [0,1]. The running
        means are updated on the voxels this view observes only, with the
        arithmetic of the JAX package's whole-grid update, so the volume
        is the same bit for bit."""
        H, W = depth.shape
        cam = self.points @ w2c[:3, :3].T + w2c[:3, 3]
        z = cam[:, 2]
        with np.errstate(divide="ignore", invalid="ignore"):
            u = ixt[0, 0] * cam[:, 0] / z + ixt[0, 2]
            v = ixt[1, 1] * cam[:, 1] / z + ixt[1, 2]
            ui = np.round(u - 0.5).astype(np.int64)
            vi = np.round(v - 0.5).astype(np.int64)
        idx = np.flatnonzero((z > 0) & (ui >= 0) & (ui < W) & (vi >= 0) & (vi < H))
        ui, vi = ui[idx], vi[idx]

        d = depth[vi, ui]
        sdf = d - z[idx]
        valid = (d > 0) & (d < depth_trunc) & (sdf > -self.sdf_trunc)
        idx, ui, vi = idx[valid], ui[valid], vi[valid]
        tsdf_new = np.clip(sdf[valid] / self.sdf_trunc, -1.0, 1.0)

        w_old = self.weight[idx]
        denom = np.maximum(w_old + 1.0, 1e-6)
        self.tsdf[idx] = (self.tsdf[idx] * w_old + tsdf_new) / denom
        self.color[idx] = (self.color[idx] * w_old[:, None] + color[vi, ui]) / denom[:, None]
        self.weight[idx] = w_old + 1.0

    def extract_mesh(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Marching tetrahedra on the fused TSDF.
        Returns (vertices [V,3], vertex_colors [V,3], triangles [T,3])."""
        dx, dy, dz = self.dims
        vol = self.tsdf.reshape(dx, dy, dz)
        wgt = self.weight.reshape(dx, dy, dz)
        col = self.color.reshape(dx, dy, dz, 3)

        # cube corner values for every cell [ncell, 8]
        cells = np.stack(np.meshgrid(np.arange(dx - 1), np.arange(dy - 1),
                                     np.arange(dz - 1), indexing="ij"), -1).reshape(-1, 3)
        cidx = cells[:, None, :] + _CORNERS[None, :, :]        # [C,8,3]
        vals = vol[cidx[..., 0], cidx[..., 1], cidx[..., 2]]   # [C,8]
        obs = wgt[cidx[..., 0], cidx[..., 1], cidx[..., 2]] > 0
        # only cells fully observed and straddling the surface
        keep = obs.all(-1) & (vals.min(-1) < 0) & (vals.max(-1) > 0)
        cells, vals, cidx = cells[keep], vals[keep], cidx[keep]
        if cells.shape[0] == 0:
            return (np.zeros((0, 3), np.float32), np.zeros((0, 3), np.float32),
                    np.zeros((0, 3), np.int64))

        corner_pos = self.aabb[0] + cidx.astype(np.float32) * self.voxel_size  # [C,8,3]
        corner_col = col[cidx[..., 0], cidx[..., 1], cidx[..., 2]]

        verts, colors, tris = [], [], []
        table = _tet_case_table()
        for tet in _TETS:
            tv = vals[:, tet]                                  # [C,4]
            tp = corner_pos[:, tet]                            # [C,4,3]
            tc = corner_col[:, tet]
            inside = tv < 0                                    # [C,4]
            code = (inside * (1 << np.arange(4))).sum(-1)      # 0..15

            for case, triangles_edges in table.items():
                if not triangles_edges:
                    continue
                mask = code == case
                if not mask.any():
                    continue
                v, p, c = tv[mask], tp[mask], tc[mask]
                n = v.shape[0]
                for edges in triangles_edges:       # one triangle = 3 edges
                    pts = []
                    cls = []
                    for a, b in edges:
                        t = np.clip(v[:, a] / (v[:, a] - v[:, b]), 0.0, 1.0)[:, None]
                        pts.append(p[:, a] * (1 - t) + p[:, b] * t)
                        cls.append(c[:, a] * (1 - t) + c[:, b] * t)
                    base = sum(len(x) for x in verts)
                    verts.append(np.stack(pts, 1).reshape(-1, 3))
                    colors.append(np.stack(cls, 1).reshape(-1, 3))
                    tris.append(base + np.arange(n * 3).reshape(n, 3))

        if not verts:
            return (np.zeros((0, 3), np.float32), np.zeros((0, 3), np.float32),
                    np.zeros((0, 3), np.int64))
        vertices = np.concatenate(verts).astype(np.float32)
        vcolors = np.concatenate(colors).astype(np.float32)
        triangles = np.concatenate(tris).astype(np.int64)
        return _weld(vertices, vcolors, triangles)


def _weld(vertices, colors, triangles, decimals: int = 6):
    """Merge duplicate vertices so connected-component analysis works: the
    rows of `np.unique(key, axis=0)` and its inverse, found by a lexsort
    (np.unique sorts the rows as a structured array, several times slower)."""
    key = np.round(vertices, decimals)
    order = np.lexsort(key.T[::-1])                      # by x, then y, then z
    key = key[order]
    first = np.ones(len(key), bool)
    first[1:] = (key[1:] != key[:-1]).any(1)
    uniq = key[first]
    inv = np.empty(len(key), np.intp)
    inv[order] = np.cumsum(first) - 1
    new_colors = np.zeros_like(uniq)
    np.maximum.at(new_colors, inv, colors)  # any representative color
    return uniq.astype(np.float32), new_colors, inv[triangles]


def keep_largest_clusters(vertices, colors, triangles, keep: int = 10):
    """Largest-connected-cluster cleanup (tools/meshExtractor.py:121-135)."""
    if len(triangles) == 0:
        return vertices, colors, triangles
    import scipy.sparse as sp
    from scipy.sparse.csgraph import connected_components

    n = len(vertices)
    e = np.concatenate([triangles[:, [0, 1]], triangles[:, [1, 2]], triangles[:, [2, 0]]])
    adj = sp.coo_matrix((np.ones(len(e)), (e[:, 0], e[:, 1])), shape=(n, n))
    _, labels = connected_components(adj, directed=False)
    tri_label = labels[triangles[:, 0]]
    sizes = np.bincount(tri_label)
    order = np.argsort(sizes)[::-1][:keep]
    mask = np.isin(tri_label, order)
    triangles = triangles[mask]
    used = np.unique(triangles)
    remap = -np.ones(n, np.int64)
    remap[used] = np.arange(len(used))
    return vertices[used], colors[used], remap[triangles]


def save_obj(path: str, vertices: np.ndarray, triangles: np.ndarray,
             colors: Optional[np.ndarray] = None):
    """Vertices (with their colours) and 1-based faces as text; each number
    is written as the float64 repr of its value, as an f-string writes a
    float32, converted in bulk."""
    rows = vertices if colors is None else np.concatenate([vertices, colors], 1)
    rows = np.asarray(rows).astype(np.float64).astype(str).tolist()
    faces = (np.asarray(triangles) + 1).astype(str).tolist()
    with open(path, "w") as f:
        f.writelines("v " + " ".join(r) + "\n" for r in rows)
        f.writelines("f " + " ".join(t) + "\n" for t in faces)


def save_ply_points(path: str, xyz: np.ndarray, normal: np.ndarray):
    """ASCII PLY point cloud (tools/meshExtractor.py:12-28 equivalent)."""
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(xyz)}\n")
        for p in ("x", "y", "z", "nx", "ny", "nz"):
            f.write(f"property float {p}\n")
        f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write("end_header\n")
        for p, n in zip(xyz, normal):
            f.write(f"{p[0]} {p[1]} {p[2]} {n[0]} {n[1]} {n[2]} 0 0 0\n")
