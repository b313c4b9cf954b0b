"""Appearance codes for novel views (counterpart of
ingp_tpu/utils/frame_embedding.py).

Given the trained per-image appearance table and the training poses,
pick the code of an arbitrary render pose by index, by the nearest
training camera, or as the mean of the two nearest cameras' codes.
"""
from __future__ import annotations

import torch


class FrameEmbedding:
    def __init__(self, embedding_table, poses):
        """embedding_table: (N_imgs, L); poses: (N_imgs, 3, 4) (tensors
        or arrays; kept on the table's device)."""
        self.table = torch.as_tensor(embedding_table).detach()
        self.poses = torch.as_tensor(poses, device=self.table.device)

    def __call__(self, x, mode="index"):
        if mode == "index":
            return self.sample_index(x)
        if mode == "nearest":
            return self.sample_nearest(x)
        if mode == "mean":
            return self.sample_mean(x)
        raise ValueError(f"Invalid mode: {mode}")

    def sample_index(self, index):
        idx = torch.as_tensor(index, device=self.table.device).reshape(-1)
        return self.table[idx]

    def _dists(self, pose):
        frames_t = self.poses[:, :3, -1]
        t = torch.as_tensor(pose, device=self.table.device,
                            dtype=self.poses.dtype)[:3, -1]
        return ((frames_t - t) ** 2).sum(1)

    def sample_nearest(self, pose):
        return self.table[torch.argmin(self._dists(pose))][None]

    def sample_mean(self, pose):
        idx = torch.argsort(self._dists(pose), stable=True)[:2]
        return self.table[idx].mean(0, keepdim=True)
