"""ctypes front end of the native batch sampler (counterpart of
ingp_tpu/native/loader.py:17-143).

`NativeBatchSampler` draws what `BaseDataset.sample_batch` draws (the
keys img_idxs, pix_idxs, uv, rgb and, where the dataset has them,
exposure, normal, depth and label), gathered by a C++ thread into a ring
of slots ahead of the consumer. Its draws are xoshiro256** seeded from
(seed, batch number), so batch n is a function of (seed, n) alone,
whatever the thread's timing: the JAX package's sampler gives the same
batches for the same dataset and seed.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from .build import build_library
    lib = ctypes.CDLL(str(build_library()))
    vp, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.sampler_create.restype = vp
    lib.sampler_create.argtypes = [ctypes.c_uint64, i64, i64, i64,
                                   ctypes.c_int]
    lib.sampler_add_field.argtypes = [vp, vp, i64]
    lib.sampler_set_labels.argtypes = [vp, vp]
    lib.sampler_start.argtypes = [vp, i64]
    lib.sampler_next.restype = i64
    lib.sampler_next.argtypes = [vp, vp, vp, ctypes.POINTER(vp), vp]
    lib.sampler_destroy.argtypes = [vp]
    return lib


def native_available() -> bool:
    """Whether the library builds and loads; a failed build raises
    RuntimeError naming its cause (there is no silent fallback)."""
    return _lib() is not None


def _field(name, arr, n_images, hw):
    """arr as a C-contiguous float32 array of rows of its last axis's
    width, which the C++ side reads at row img * hw + pix, as JAX's
    sampler does (an array of more rows than n_images * hw, such as the
    kitti and highbay loaders' normals at their files' size below
    downsample 1, is read at the resized image's stride, as in JAX); or
    ValueError where it holds fewer rows (JAX's would read past it)."""
    arr = np.ascontiguousarray(arr, np.float32)
    if arr.ndim < 2 or arr.size < n_images * hw * arr.shape[-1]:
        raise ValueError(f"{name} has shape {arr.shape}, the sampler reads "
                         f"{n_images} x {hw} rows of its last axis")
    return arr


class NativeBatchSampler:
    """Batches of a BaseDataset-style container (rays (N, h*w, 3 or 4),
    poses, img_wh; labels, normals and depths_2d where present), gathered
    on a background thread.

        sampler = NativeBatchSampler(dataset, batch_size, seed)
        batch = sampler.next_batch()   # a dict like sample_batch()'s
        sampler.close()                # joins the thread

    Raises ValueError for a dataset whose arrays hold fewer than
    n_images x h*w rows (the caller may then sample with numpy)."""

    def __init__(self, dataset, batch_size, seed=0, strategy=None,
                 n_slots=4):
        strategy = strategy or getattr(dataset, "ray_sampling_strategy",
                                       "all_images")
        if strategy not in ("all_images", "same_image"):
            raise ValueError(f"unknown strategy {strategy}")
        n_images = len(dataset.poses)
        w, h = dataset.img_wh
        if n_images < 1 or w * h < 1 or batch_size < 1:
            raise ValueError(f"nothing to sample: {n_images} images of "
                             f"{w}x{h}, batch {batch_size}")
        self.batch_size = int(batch_size)
        self.img_wh = (w, h)
        # the C++ side reads these arrays in place: keep them alive
        self._fields = [("rgb", _field("rays", dataset.rays, n_images,
                                       w * h))]
        if hasattr(dataset, "normals"):
            self._fields.append(("normal", _field(
                "normals", dataset.normals, n_images, w * h)))
        if hasattr(dataset, "depths_2d"):
            self._fields.append(("depth", _field(
                "depths_2d", np.asarray(dataset.depths_2d)[..., None],
                n_images, w * h)))
        self._labels = None
        if hasattr(dataset, "labels"):
            self._labels = np.ascontiguousarray(dataset.labels, np.int64)
            if self._labels.size < n_images * w * h:
                raise ValueError(f"labels has shape {self._labels.shape}, "
                                 f"the sampler reads {n_images} x {w * h}")
        lib = self._lib = _lib()
        self._h = lib.sampler_create(int(seed) & (2 ** 64 - 1), n_images,
                                     w * h, self.batch_size,
                                     1 if strategy == "same_image" else 0)
        for _, arr in self._fields:
            lib.sampler_add_field(self._h, arr.ctypes.data, arr.shape[-1])
        if self._labels is not None:
            lib.sampler_set_labels(self._h, self._labels.ctypes.data)
        lib.sampler_start(self._h, n_slots)

    def next_batch(self) -> dict:
        if not self._h:
            raise RuntimeError("the sampler is closed")
        B = self.batch_size
        img_idx = np.empty(B, np.int32)
        pix_idx = np.empty(B, np.int32)
        outs = [np.empty((B, arr.shape[-1]), np.float32)
                for _, arr in self._fields]
        ptrs = (ctypes.c_void_p * len(outs))(*[o.ctypes.data for o in outs])
        label = np.empty(B, np.int64) if self._labels is not None else None
        self._lib.sampler_next(self._h, img_idx.ctypes.data,
                               pix_idx.ctypes.data, ptrs,
                               None if label is None else label.ctypes.data)
        batch = {"img_idxs": img_idx, "pix_idxs": pix_idx}
        for (name, _), arr in zip(self._fields, outs):
            if name == "rgb":
                batch["rgb"] = arr[:, :3]
                if arr.shape[1] == 4:
                    batch["exposure"] = arr[:, 3:]
            elif name == "depth":
                batch["depth"] = arr[:, 0]
            else:
                batch[name] = arr
        if label is not None:
            batch["label"] = label
        w = self.img_wh[0]
        batch["uv"] = np.stack([pix_idx // w, pix_idx % w],
                               -1).astype(np.float32)
        return batch

    def close(self) -> None:
        """Stop and join the sampler's thread; later calls do nothing."""
        h, self._h = getattr(self, "_h", None), None
        if h:
            self._lib.sampler_destroy(h)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        self.close()
