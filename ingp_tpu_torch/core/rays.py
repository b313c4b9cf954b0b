"""Ray geometry (counterpart of ingp_tpu/core/rays.py): ray directions
and rays (get_rays, axisangle_to_R in torch), and the loaders' host pose
helpers in numpy (:106-200)."""
from __future__ import annotations

import numpy as np
import torch


def get_ray_directions(H, W, K, random=False, return_uv=False, flatten=True,
                       anti_aliasing_factor=1.0, rng=None):
    """Pixel -> camera-space ray directions, [right down front]
    convention, pixel centres at +0.5 (or a uniform draw in the pixel
    from the numpy Generator rng when random). With
    anti_aliasing_factor > 1 the grid and K are scaled up by it. Returns
    float32 numpy (H*W, 3) (or (H, W, 3) when not flatten), and with
    return_uv also the (u, v) pixel grid, as the JAX package does."""
    K = np.asarray(K, dtype=np.float64).copy()
    if anti_aliasing_factor > 1.0:
        H = int(H * anti_aliasing_factor)
        W = int(W * anti_aliasing_factor)
        K *= anti_aliasing_factor
        K[2, 2] = 1
    v, u = np.meshgrid(np.arange(H, dtype=np.float32),
                       np.arange(W, dtype=np.float32), indexing="ij")
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    if random:
        rng = rng or np.random.default_rng()
        du = rng.random(u.shape, dtype=np.float32)
        dv = rng.random(v.shape, dtype=np.float32)
    else:
        du = dv = 0.5
    directions = np.stack([(u - cx + du) / fx,
                           (v - cy + dv) / fy,
                           np.ones_like(u)], -1).astype(np.float32)
    grid = np.stack([u, v], -1).astype(np.float32)
    if flatten:
        directions = directions.reshape(-1, 3)
        grid = grid.reshape(-1, 2)
    return (directions, grid) if return_uv else directions


def get_rays(directions: torch.Tensor, c2w: torch.Tensor):
    """Camera-space dirs (N, 3) + c2w (3, 4) or (N, 3, 4) -> world
    (rays_o, rays_d), both (N, 3). Directions are not normalised."""
    if c2w.ndim == 2:
        rays_d = directions @ c2w[:, :3].T
        rays_o = c2w[:, 3].expand_as(rays_d)
    else:
        rays_d = torch.einsum("nc,nbc->nb", directions, c2w[..., :3])
        rays_o = c2w[..., 3].expand_as(rays_d)
    return rays_o, rays_d


def axisangle_to_R(v):
    """Rodrigues axis-angle -> rotation matrix, (B, 3) -> (B, 3, 3) (or
    (3,) -> (3, 3)); differentiable, with the +1e-7 norm guard and the
    sqrt(|v|^2 + 1e-14) norm that keeps the gradient finite at v = 0."""
    squeeze = v.ndim == 1
    if squeeze:
        v = v[None]
    zero = torch.zeros_like(v[:, :1])
    skew = torch.stack([
        torch.cat([zero, -v[:, 2:3], v[:, 1:2]], 1),
        torch.cat([v[:, 2:3], zero, -v[:, 0:1]], 1),
        torch.cat([-v[:, 1:2], v[:, 0:1], zero], 1)], 1)
    norm = torch.sqrt((v * v).sum(1) + 1e-14)[:, None, None] + 1e-7
    eye = torch.eye(3, dtype=v.dtype, device=v.device)
    R = eye + (torch.sin(norm) / norm) * skew \
        + ((1 - torch.cos(norm)) / norm ** 2) * (skew @ skew)
    return R[0] if squeeze else R


# -- host pose helpers (numpy) ----------------------------------------------

def normalize(v):
    return v / np.linalg.norm(v)


def average_poses(poses, pts3d=None):
    """The average c2w pose of a capture (3, 4): centre at the points'
    (or the cameras') mean, z the mean viewing axis, y from the mean up."""
    center = pts3d.mean(0) if pts3d is not None else poses[..., 3].mean(0)
    z = normalize(poses[..., 2].mean(0))
    y_ = poses[..., 1].mean(0)
    x = normalize(np.cross(y_, z))
    y = np.cross(z, x)
    return np.stack([x, y, z, center], 1)


def center_poses(poses, pts3d=None):
    """Poses (and points) recentred by the inverse of the average pose."""
    pose_avg_homo = np.eye(4)
    pose_avg_homo[:3] = average_poses(poses, pts3d)
    pose_avg_inv = np.linalg.inv(pose_avg_homo)
    last_row = np.tile(np.array([0, 0, 0, 1.0]), (len(poses), 1, 1))
    poses_centered = (pose_avg_inv @ np.concatenate([poses, last_row], 1)
                      )[:, :3]
    if pts3d is not None:
        return poses_centered, (pts3d @ pose_avg_inv[:, :3].T
                                + pose_avg_inv[:, 3:].T)
    return poses_centered


def create_spheric_poses(radius, mean_h, n_poses=120):
    """(n_poses, 3, 4) cameras on a circle of `radius` around the y axis
    at elevation -pi/12, looking at the centre, in the dataset
    convention (the orientation A @ R_y(theta) @ R_x(phi) with the axis
    remap A = [[-1, 0, 0], [0, 0, 1], [0, 1, 0]] folded in)."""
    phi = -np.pi / 12
    th = np.linspace(0, 2 * np.pi, n_poses + 1)[:-1]
    ct, st = np.cos(th), np.sin(th)
    cp, sp = np.cos(phi), np.sin(phi)
    R = np.empty((n_poses, 3, 3))
    R[:, 0] = np.stack([-ct, st * sp, st * cp], -1)
    R[:, 1] = np.stack([np.broadcast_to(st, ct.shape), ct * sp,
                        ct * cp], -1)
    R[:, 2] = np.stack([np.zeros_like(ct), np.full_like(ct, cp),
                        np.full_like(ct, -sp)], -1)
    t = R @ np.array([0.0, 2 * mean_h, -radius])  # the camera centres
    return np.concatenate([R, t[:, :, None]], axis=-1)


def viewmatrix(lookdir, up, position):
    """Camera-to-world (3, 4) from a forward and an up hint."""
    vec2 = normalize(lookdir)
    vec0 = normalize(np.cross(up, vec2))
    vec1 = normalize(np.cross(vec2, vec0))
    return np.stack([vec0, vec1, vec2, position], axis=1)


def generate_interpolated_path(poses, n_interp, spline_degree=5,
                               smoothness=0.03, rot_weight=0.1):
    """A smooth B-spline camera path through keyframe poses: each pose
    becomes a (position, look-at, up) point triple, the triples are
    fitted by one spline (scipy.interpolate.splprep), and the n_interp *
    (n - 1) sampled triples are turned back into orthonormal poses
    (n_interp * (n - 1), 3, 4)."""
    import scipy.interpolate

    pos = poses[:, :3, -1]
    triples = np.stack([pos,
                        pos - rot_weight * poses[:, :3, 2],
                        pos + rot_weight * poses[:, :3, 1]], 1)
    n = n_interp * (triples.shape[0] - 1)
    flat = triples.reshape(triples.shape[0], -1)
    k = min(spline_degree, flat.shape[0] - 1)
    tck, _ = scipy.interpolate.splprep(flat.T, k=k, s=smoothness)
    u = np.linspace(0, 1, n, endpoint=False)
    samples = np.asarray(scipy.interpolate.splev(u, tck)).T.reshape(n, 3, 3)
    p, lookat, up = samples[:, 0], samples[:, 1], samples[:, 2]
    fwd = p - lookat
    vec2 = fwd / np.linalg.norm(fwd, axis=-1, keepdims=True)
    vec0 = np.cross(up - p, vec2)
    vec0 /= np.linalg.norm(vec0, axis=-1, keepdims=True)
    vec1 = np.cross(vec2, vec0)
    vec1 /= np.linalg.norm(vec1, axis=-1, keepdims=True)
    return np.stack([vec0, vec1, vec2, p], axis=-1)


class PathRays:
    """The mapping `path_rays(directions, c2w_list)` returns, each entry
    built when it is read (equal values; entries are not kept): a street
    scene's 400-pose path at 1408x376 would hold 5 GB of rays."""

    def __init__(self, directions, c2w_list):
        self.directions = directions
        self.c2w_list = c2w_list

    def __len__(self):
        return len(self.c2w_list)

    def __iter__(self):
        return iter(range(len(self)))

    def __getitem__(self, idx):
        if not 0 <= idx < len(self):
            raise KeyError(idx)
        return path_rays(self.directions, self.c2w_list[idx:idx + 1])[0]


def path_rays(directions, c2w_list):
    """{index: (N, 6) float32 rays_o | rays_d} along a camera path, as
    the loaders' get_path_rays build them (get_rays in numpy, float32)."""
    rays = {}
    for idx in range(len(c2w_list)):
        c2w = np.asarray(c2w_list[idx][:3], np.float32)
        rays_d = directions @ c2w[:, :3].T
        rays_o = np.broadcast_to(c2w[:, 3], rays_d.shape)
        rays[idx] = np.concatenate([rays_o, rays_d], 1)
    return rays
