"""Mesh extraction from the density field (counterpart of
ingp_tpu/render/mesh.py).

A dense density probe over the scene box in chunks of 2^17 points, then
the JAX module's isosurface: marching tetrahedra (each cell split into 6
tetrahedra, 16 cases), its triangles in the same order (tetrahedron,
then case, then triangle, then cell), the crossing interpolated in
float64 and clipped to [0, 1], the vertices welded by their value
rounded to 6 decimals and ordered lexicographically. So the vertices
and faces equal the JAX module's on the same volume, and `write_ply`
writes the same bytes.

The isosurface runs on the volume's device. It never holds per-cell
corner arrays (the JAX module's (cells, 8, 3) int64 positions are 6.4 GB
at 512x128x512): each tetrahedron's 4-bit case code is built from
strided views of the (X, Y, Z) inside-mask, one uint8 per cell (33 MB at
that size), and only the cells that the surface crosses are gathered.
"""
from __future__ import annotations

import numpy as np
import torch

# the 6 tetrahedra of a cube, as indices into its 8 corners; corner i is
# (i & 1, (i >> 1) & 1, (i >> 2) & 1)
_TETS = ((0, 5, 1, 3), (0, 5, 3, 7), (0, 5, 7, 4), (0, 7, 3, 2),
         (0, 7, 2, 6), (0, 7, 6, 4))
_CORNERS = tuple((i & 1, (i >> 1) & 1, (i >> 2) & 1) for i in range(8))
WELD_DECIMALS = 6


def _tet_triangles(inside):
    """The triangles of one tetrahedron's occupancy (4 bools), each a
    triple of cut edges (pairs of its local vertex ids)."""
    idx = [i for i in range(4) if inside[i]]
    out = [i for i in range(4) if not inside[i]]
    if len(idx) in (0, 4):
        return []
    if len(idx) == 1:
        e = [(idx[0], b) for b in out]
        return [(e[0], e[1], e[2])]
    if len(idx) == 3:
        e = [(b, out[0]) for b in idx]
        return [(e[0], e[2], e[1])]
    (a, b), (c, d) = idx, out
    return [((a, c), (b, c), (b, d)), ((a, c), (b, d), (a, d))]


_CASES = [_tet_triangles([(i >> k) & 1 for k in range(4)])
          for i in range(16)]


def _weld(V):
    """(unique rows of round(V, 6) in lexicographic order, the index of
    each row of V among them)."""
    scale = 10.0 ** WELD_DECIMALS
    key = torch.round(V * scale)               # integers, exact in float64
    perm = torch.argsort(key[:, 2], stable=True)
    for axis in (1, 0):
        perm = perm[torch.argsort(key[perm, axis], stable=True)]
    ks = key[perm]
    new = torch.ones(len(ks), dtype=torch.bool, device=V.device)
    new[1:] = (ks[1:] != ks[:-1]).any(1)
    inv = torch.empty_like(perm)
    inv[perm] = torch.cumsum(new, 0) - 1
    return ks[new] / scale, inv


def marching_cubes(volume, level):
    """Isosurface of an (X, Y, Z) scalar volume (a tensor, on its device)
    by marching tetrahedra. Returns (vertices (V, 3) float64 in voxel
    coordinates, faces (F, 3) int64), on the volume's device."""
    vol = torch.as_tensor(volume).to(torch.float64)
    dev = vol.device
    X, Y, Z = vol.shape
    cx, cy, cz = X - 1, Y - 1, Z - 1
    inside = vol > level

    def at(a, corner):
        dx, dy, dz = _CORNERS[corner]
        return a[dx:dx + cx, dy:dy + cy, dz:dz + cz]
    tris = []
    for tet in _TETS:
        code = torch.zeros((cx, cy, cz), dtype=torch.uint8, device=dev)
        for k in range(4):
            code |= at(inside, tet[k]).to(torch.uint8) << k
        code = code.reshape(-1)
        cells = torch.nonzero((code != 0) & (code != 15)).squeeze(1)
        codes = code[cells]
        for case in range(1, 15):
            sel = cells[codes == case]
            if not len(sel):
                continue
            ox = sel // (cy * cz)
            oy = (sel // cz) % cy
            oz = sel % cz
            pos, val = [], []
            for corner in tet:
                dx, dy, dz = _CORNERS[corner]
                p = torch.stack([ox + dx, oy + dy, oz + dz], -1)
                pos.append(p.to(torch.float64))
                val.append(vol[p[:, 0], p[:, 1], p[:, 2]])
            for tri in _CASES[case]:
                pts = []
                for a, b in tri:
                    va, vb = val[a], val[b]
                    diff = vb - va
                    t = (level - va) / torch.where(diff == 0, 1e-12, diff)
                    t = torch.clamp(t, 0.0, 1.0)[:, None]
                    pts.append(pos[a] + t * (pos[b] - pos[a]))
                tris.append(torch.stack(pts, 1).reshape(-1, 3))
    if not tris:
        return (torch.zeros((0, 3), dtype=torch.float64, device=dev),
                torch.zeros((0, 3), dtype=torch.int64, device=dev))
    verts, inv = _weld(torch.cat(tris))
    return verts, inv.reshape(-1, 3)


def write_ply(path, verts, faces):
    """Binary little-endian PLY: float32 x, y, z per vertex, a uchar 3
    and three int32 indices per face (tensors or arrays)."""
    verts = np.asarray(torch.as_tensor(verts).cpu())
    faces = np.asarray(torch.as_tensor(faces).cpu())
    with open(path, "wb") as f:
        head = (f"ply\nformat binary_little_endian 1.0\n"
                f"element vertex {len(verts)}\n"
                "property float x\nproperty float y\nproperty float z\n"
                f"element face {len(faces)}\n"
                "property list uchar int vertex_indices\nend_header\n")
        f.write(head.encode())
        verts.astype("<f4").tofile(f)
        rec = np.empty(len(faces), dtype=[("n", "u1"), ("idx", "<i4", 3)])
        rec["n"] = 3
        rec["idx"] = faces
        rec.tofile(f)


def probe_density(density_fn, params, scale, resolution, chunk, device):
    """density_fn(params, x (n, 3)) -> (n,) sigma on the (rx, ry, rz)
    lattice over [-scale, scale]^3 (x slowest), chunk points at a time,
    the tail after the first chunk padded with its last point. Returns
    the (rx, ry, rz) float32 volume and the three axes (numpy float64)."""
    rx, ry, rz = resolution
    axes = [np.linspace(-scale, scale, r) for r in resolution]
    ax = [torch.as_tensor(a.astype(np.float32), device=device) for a in axes]
    n = rx * ry * rz
    sig = torch.empty(n, dtype=torch.float32, device=device)
    with torch.no_grad():
        for i in range(0, n, chunk):
            end = min(i + chunk, n)
            p = torch.arange(i, end, device=device)
            if end - i < chunk and i > 0:
                p = torch.cat([p, p[-1:].expand(chunk - (end - i))])
            pts = torch.stack([ax[0][p // (ry * rz)], ax[1][(p // rz) % ry],
                               ax[2][p % rz]], -1)
            sig[i:end] = density_fn(params, pts)[:end - i]
    return sig.reshape(rx, ry, rz), axes


def extract_mesh(density_fn, params, scale, resolution=(512, 128, 512),
                 sigma_threshold=10.0, chunk=2 ** 17, out_path=None):
    """The density probe (`probe_density`) -> isosurface at
    sigma_threshold -> optional .ply at out_path, on the device of
    params' density MLP. Returns (vertices (V, 3) float64 in world
    coordinates, faces (F, 3) int64), tensors on that device."""
    vol, (xs, ys, zs) = probe_density(density_fn, params, scale,
                                      tuple(resolution), chunk,
                                      params["xyz_net"][0]["w"].device)
    verts, faces = marching_cubes(vol, sigma_threshold)
    step = torch.as_tensor(np.array([xs[1] - xs[0], ys[1] - ys[0],
                                     zs[1] - zs[0]]), device=verts.device)
    origin = torch.as_tensor(np.array([xs[0], ys[0], zs[0]]),
                             device=verts.device)
    verts = verts * step[None] + origin
    if out_path:
        write_ply(out_path, verts, faces)
    return verts, faces
