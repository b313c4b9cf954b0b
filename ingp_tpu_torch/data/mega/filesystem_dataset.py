"""The out-of-core shuffled Mega-NeRF ray store (counterpart of
ingp_tpu/data/mega/filesystem_dataset.py): the rays of a scene too large
for memory are shuffled once into chunks on disk, and training cycles
through the chunks with one thread loading the next while the current
one feeds batches; get_state / set_state (the chunk's name) resume it.

The semantics are the JAX store's: chunks allocated over the directories
by each one's share of their free disk; every flush of disk_flush_size
rays permuted by one default_rng(0) stream and split evenly (ceil) over
the chunks, so the last ones may be short or empty; image indices as
uint16 where the largest fits; pixel indices (rays rebuilt at load time,
the altitude range clamping them there) when every image has the same
size and intrinsics, else full 8-float rays; a metadata.npy record in
each directory, and existing chunk directories reused when it matches.

The storage codec is the port's own, so that the port needs no pyarrow
installed: each chunk is a directory NNNNNN.chunk of uncompressed .npy
files, one per column of the JAX store's parquet schema (img_indices,
rgbs_0-2, and pixel_indices or rays_0-7). A flush appends to each file;
closing writes its header's row count, so np.load reads it (and can map
it). A directory of the JAX store's .parquet chunks is refused by name."""
from __future__ import annotations

import math
import shutil
import struct
from concurrent.futures import ThreadPoolExecutor
from itertools import cycle
from pathlib import Path

import numpy as np

from .ray_utils import (_truncate_with_plane_intersection,
                        get_ray_directions, get_rays)

RAY_CHUNK_SIZE = 64 * 1024
CHUNK_SUFFIX = ".chunk"
NPY_HEADER_BYTES = 128


def _npy_header(dtype: np.dtype, rows: int) -> bytes:
    """A version-1.0 .npy header of a 1-D array, padded to
    NPY_HEADER_BYTES so that it can be rewritten in place."""
    text = "{'descr': %r, 'fortran_order': False, 'shape': (%d,), }" % (
        np.lib.format.dtype_to_descr(np.dtype(dtype)), rows)
    pad = NPY_HEADER_BYTES - 10 - len(text) - 1
    return (b"\x93NUMPY\x01\x00" + struct.pack("<H", NPY_HEADER_BYTES - 10)
            + text.encode("latin1") + b" " * pad + b"\n")


class ChunkWriter:
    """One chunk directory being written: a .npy file per column, each
    flush appended, the row count written into the headers on close."""

    def __init__(self, path: Path, schema):
        path.mkdir()
        self.path, self.schema, self.rows = path, schema, 0
        self.files = {name: open(path / f"{name}.npy", "wb")
                      for name, _ in schema}
        for name, dtype in schema:
            self.files[name].write(_npy_header(dtype, 0))

    def write(self, cols) -> None:
        for name, dtype in self.schema:
            self.files[name].write(
                np.ascontiguousarray(cols[name], dtype).tobytes())
        self.rows += len(cols[self.schema[0][0]])

    def close(self) -> None:
        for name, dtype in self.schema:
            f = self.files[name]
            f.seek(0)
            f.write(_npy_header(dtype, self.rows))
            f.close()


def read_chunk(path: Path) -> dict:
    """{column: array} of a chunk directory."""
    return {p.stem: np.load(p) for p in sorted(path.glob("*.npy"))}


class FilesystemDataset:
    def __init__(self, metadata_items, near, far, ray_altitude_range,
                 center_pixels, chunk_paths, num_chunks, scale_factor,
                 disk_flush_size=10_000_000):
        self._c2ws = np.stack([x.c2w for x in metadata_items])
        self._near = near
        self._far = far
        self._ray_altitude_range = ray_altitude_range

        intr = np.stack([np.concatenate([[x.W, x.H], x.intrinsics])
                         for x in metadata_items])
        if np.abs(intr - intr[0]).max() == 0:
            # one camera: store pixel indices, rebuild the rays at load
            it = metadata_items[0]
            self._directions = get_ray_directions(
                it.W, it.H, *it.intrinsics[:4], center_pixels
            ).reshape(-1, 3)
        else:
            self._directions = None

        chunk_paths = [Path(p) for p in chunk_paths]
        existing = self._check_existing_paths(chunk_paths, center_pixels,
                                              scale_factor,
                                              len(metadata_items))
        if existing is not None:
            self._chunk_paths = existing
        else:
            self._chunk_paths = []
            self._write_chunks(metadata_items, center_pixels, chunk_paths,
                               num_chunks, scale_factor, disk_flush_size)
        self._chunk_paths.sort(key=lambda x: x.name)

        self._chunk_index = cycle(range(len(self._chunk_paths)))
        self._loaded_rgbs = None
        self._loaded_rays = None
        self._loaded_img_indices = None
        self._executor = ThreadPoolExecutor(max_workers=1)
        self._chunk_future = self._executor.submit(self._load_chunk_inner)
        self._chosen = None

    def load_chunk(self):
        """Take the prefetched chunk and start loading the next."""
        (self._chosen, self._loaded_rgbs, self._loaded_rays,
         self._loaded_img_indices) = self._chunk_future.result()
        self._chunk_future = self._executor.submit(self._load_chunk_inner)

    def get_state(self):
        return self._chosen

    def set_state(self, chosen):
        while self._chosen != chosen:
            self.load_chunk()

    def __len__(self):
        return self._loaded_rgbs.shape[0]

    def __getitem__(self, idx):
        return {"rgbs": self._loaded_rgbs[idx],
                "rays": self._loaded_rays[idx],
                "img_indices": self._loaded_img_indices[idx]}

    def sample_batch(self, rng, batch_size):
        idx = rng.integers(0, len(self), batch_size)
        return self[idx]

    def _load_chunk_inner(self):
        chosen = self._chunk_paths[next(self._chunk_index)]
        t = read_chunk(chosen)
        img_indices = t["img_indices"].astype(np.int32)

        if self._directions is not None:
            pix = t["pixel_indices"]
            rays = np.empty((len(pix), 8), np.float32)
            for i in range(0, len(pix), RAY_CHUNK_SIZE):
                sl = slice(i, i + RAY_CHUNK_SIZE)
                dirs = self._directions[pix[sl]]
                c2w = self._c2ws[img_indices[sl]]
                rd = np.einsum("nc,nrc->nr", dirs, c2w[:, :, :3])
                rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
                ro = c2w[:, :, 3]
                rays[sl, 0:3] = ro
                rays[sl, 3:6] = rd
                rays[sl, 6] = self._near
                rays[sl, 7] = self._far
            if self._ray_altitude_range is not None:
                near_b = rays[:, 6:7]
                far_b = rays[:, 7:8]
                _truncate_with_plane_intersection(
                    rays[:, 0:3], rays[:, 3:6],
                    self._ray_altitude_range[0], near_b)
                _truncate_with_plane_intersection(
                    rays[:, 0:3], rays[:, 3:6],
                    self._ray_altitude_range[1], far_b)
                rays[:, 6] = np.maximum(near_b[:, 0], self._near)
                rays[:, 7] = np.maximum(rays[:, 6],
                                        np.minimum(far_b[:, 0],
                                                   self._far))
        else:
            rays = np.stack([t[f"rays_{i}"] for i in range(8)],
                            -1).astype(np.float32)

        rgbs = np.stack([t[f"rgbs_{i}"] for i in range(3)],
                        -1).astype(np.float32) / 255.0
        return str(chosen), rgbs, rays, img_indices

    def _write_chunks(self, metadata_items, center_pixels, chunk_paths,
                      num_chunks, scale_factor, disk_flush_size):
        path_frees, total_free = [], 0
        for p in chunk_paths:
            p.mkdir(parents=True)
            _, _, free = shutil.disk_usage(p)
            total_free += free
            path_frees.append(free)

        max_index = max(x.image_index for x in metadata_items)
        idx_dtype = np.uint16 if max_index <= np.iinfo(np.uint16).max \
            else np.int32
        schema = [("img_indices", idx_dtype)]
        schema += [(f"rgbs_{i}", np.uint8) for i in range(3)]
        if self._directions is not None:
            schema.append(("pixel_indices", np.int32))
        else:
            schema += [(f"rays_{i}", np.float32) for i in range(8)]

        writers = []
        index = 0
        for p, free in zip(chunk_paths, path_frees):
            allocated = int(free / total_free * num_chunks)
            for _ in range(allocated):
                chunk = p / f"{index:06d}{CHUNK_SUFFIX}"
                self._chunk_paths.append(chunk)
                writers.append(ChunkWriter(chunk, schema))
                index += 1

        rng = np.random.default_rng(0)
        buf_rgbs, buf_rays, buf_idx, count = [], [], [], 0
        for item in metadata_items:
            rgbs = item.load_image().reshape(-1, 3).astype(np.uint8)
            keep = item.load_mask()
            img_idx = np.full(len(rgbs), item.image_index, idx_dtype)
            if self._directions is not None:
                rays = np.arange(len(rgbs), dtype=np.int32)
            else:
                dirs = get_ray_directions(item.W, item.H,
                                          *item.intrinsics[:4],
                                          center_pixels)
                rays = get_rays(dirs, item.c2w, self._near, self._far,
                                self._ray_altitude_range).reshape(-1, 8)
            if keep is not None:
                m = keep.reshape(-1)
                rgbs, rays, img_idx = rgbs[m], rays[m], img_idx[m]
            buf_rgbs.append(rgbs)
            buf_rays.append(rays)
            buf_idx.append(img_idx)
            count += len(rgbs)
            if count >= disk_flush_size:
                self._flush(rng, writers, buf_rgbs, buf_rays, buf_idx,
                            idx_dtype)
                buf_rgbs, buf_rays, buf_idx, count = [], [], [], 0
        if count:
            self._flush(rng, writers, buf_rgbs, buf_rays, buf_idx,
                        idx_dtype)

        for p in chunk_paths:
            meta = {"images": len(metadata_items),
                    "scale_factor": scale_factor}
            if self._directions is None:
                meta.update(near=self._near, far=self._far,
                            center_pixels=center_pixels,
                            ray_altitude_range=self._ray_altitude_range)
            np.save(p / "metadata.npy", meta, allow_pickle=True)
        for w in writers:
            w.close()

    def _flush(self, rng, writers, buf_rgbs, buf_rays, buf_idx,
               idx_dtype):
        """One permutation of the buffered rays, split ceil(n / chunks) a
        chunk: the last chunks get fewer, or none."""
        rgbs = np.concatenate(buf_rgbs)
        rays = np.concatenate(buf_rays)
        img_idx = np.concatenate(buf_idx)
        perm = rng.permutation(len(rgbs))
        rgbs, rays, img_idx = rgbs[perm], rays[perm], img_idx[perm]
        n = len(writers)
        csize = math.ceil(len(rgbs) / n)
        for w_i, writer in enumerate(writers):
            sl = slice(w_i * csize, (w_i + 1) * csize)
            cols = {"img_indices": img_idx[sl].astype(idx_dtype)}
            for i in range(3):
                cols[f"rgbs_{i}"] = rgbs[sl, i]
            if self._directions is not None:
                cols["pixel_indices"] = rays[sl].astype(np.int32)
            else:
                for i in range(8):
                    cols[f"rays_{i}"] = rays[sl, i].astype(np.float32)
            writer.write(cols)

    def _check_existing_paths(self, chunk_paths, center_pixels,
                              scale_factor, images):
        """The chunks already under chunk_paths, or None where none of
        them exists; every one must hold metadata.npy for the same image
        count and scale factor."""
        files, num_exist = [], 0
        for p in chunk_paths:
            if p.exists():
                meta_p = p / "metadata.npy"
                if not meta_p.exists():
                    raise ValueError(f"{p}: incomplete chunk directory from "
                                     f"a previous run (no metadata.npy)")
                parquet = sorted(c.name for c in p.glob("*.parquet"))
                if parquet:
                    raise NotImplementedError(
                        f"{p}: parquet chunks ({parquet[0]}, ...) of the JAX "
                        f"package's store; the port reads its own .npy "
                        f"chunks (it has no pyarrow): write the store anew "
                        f"into another directory")
                meta = np.load(meta_p, allow_pickle=True).item()
                if meta["images"] != images or \
                        meta["scale_factor"] != scale_factor:
                    raise ValueError(
                        f"{p}: chunks of {meta['images']} images at scale "
                        f"{meta['scale_factor']}, not {images} at "
                        f"{scale_factor}")
                files += [c for c in p.iterdir()
                          if c.name != "metadata.npy"]
                num_exist += 1
        if num_exist:
            if num_exist != len(chunk_paths):
                raise ValueError(f"{num_exist} of the {len(chunk_paths)} "
                                 f"chunk directories exist")
            return files
        return None
