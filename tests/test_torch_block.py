"""The port's standalone data tools against the JAX package's: the
Block-NeRF TFRecord reader and extractor (ingp_tpu_torch/data/block.py:
iter_tfrecord, parse_example, extract_block_images on records written as
tests/test_block.py writes them, with PNG and JPEG image bytes; the PNGs
each writes hold equal pixels) and the snow sampler (data/snow.py
SnowSeed: its arrays and a batch from a seeded generator)."""
import io as pyio
import os

import imageio.v2 as imageio
import numpy as np
import pytest
from PIL import Image

from ingp_tpu.data import block as jb
from ingp_tpu.data import snow as jsnow
from ingp_tpu_torch.data import block as tb
from ingp_tpu_torch.data import snow as tsnow
from tests._torch_threads import one_torch_thread  # noqa: F401
from tests.test_block import _example, _tfrecord_bytes


def _encoded(img, fmt, **kw) -> bytes:
    buf = pyio.BytesIO()
    Image.fromarray(img).save(buf, fmt, **kw)
    return buf.getvalue()


def _records(rng):
    """Examples with PNG (RGB, RGBA, gray) and JPEG (4:2:0, 4:4:4, gray)
    images, hashes, floats, and one record without an image."""
    imgs = [rng.integers(0, 256, s, dtype=np.uint8)
            for s in ((6, 9, 3), (5, 7, 4), (8, 8), (17, 23, 3), (9, 16, 3),
                      (12, 10))]
    encoded = [_encoded(imgs[0], "PNG"), _encoded(imgs[1], "PNG"),
               _encoded(imgs[2], "PNG"),
               _encoded(imgs[3], "JPEG", quality=90),
               _encoded(imgs[4], "JPEG", quality=75, subsampling=0),
               _encoded(imgs[5], "JPEG", quality=95)]
    recs = []
    for i, data in enumerate(encoded):
        feats = {"image": ("bytes", [data]),
                 "ray_origins": ("float", [0.5 * i, -1.25, 3.0])}
        if i != 2:      # one image named by the running count instead
            feats["image_hash"] = ("int", [1000 + 7 * i])
        recs.append(_example(feats))
    recs.insert(3, _example({"image_hash": ("int", [5]),
                             "intrinsics": ("float", [1.0, 2.0])}))
    return recs


def test_tfrecord_and_examples_match_jax(tmp_path):
    rng = np.random.default_rng(0)
    path = tmp_path / "a.tfrecord"
    path.write_bytes(_tfrecord_bytes(_records(rng)))
    got = list(tb.iter_tfrecord(str(path)))
    ref = list(jb.iter_tfrecord(str(path)))
    assert got == ref and len(got) == 7
    for g, r in zip(got, ref):
        a, b = tb.parse_example(g), jb.parse_example(r)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k] == b[k], k


def test_extract_block_images_matches_jax(tmp_path):
    rng = np.random.default_rng(1)
    paths = []
    for n in range(2):
        p = tmp_path / f"{n}.tfrecord"
        p.write_bytes(_tfrecord_bytes(_records(rng)))
        paths.append(str(p))
    n_got = tb.extract_block_images(paths, str(tmp_path / "port"))
    n_ref = jb.extract_block_images(paths, str(tmp_path / "jax"))
    assert n_got == n_ref == 12
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == names
    for name in names:
        a = imageio.imread(tmp_path / "port" / name)
        b = imageio.imread(tmp_path / "jax" / name)
        assert a.shape == b.shape and a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("up,height,interval", [
    ((0, 1, 0), 2.0, 0.1), ((0.2, 0.9, -0.1), 1.5, 0.05)])
def test_snow_seed_matches_jax(up, height, interval):
    ang = 0.3
    R = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                  [-np.sin(ang), 0, np.cos(ang)]])
    a = tsnow.SnowSeed(up, height, R, interval=interval, range_=1.0,
                       batch_size=64)
    b = jsnow.SnowSeed(up, height, R, interval=interval, range_=1.0,
                       batch_size=64)
    for k in ("up", "coord_2d", "rays_o", "rays_d"):
        x, y = getattr(a, k), getattr(b, k)
        assert x.dtype == y.dtype and x.shape == y.shape, k
        np.testing.assert_array_equal(x, y, err_msg=k)
    assert len(a) == len(b) == 1000
    for bs in (None, 17):
        s = a.sample_batch(np.random.default_rng(3), bs)
        r = b.sample_batch(np.random.default_rng(3), bs)
        assert sorted(s) == sorted(r)
        for k in s:
            np.testing.assert_array_equal(s[k], r[k], err_msg=k)
