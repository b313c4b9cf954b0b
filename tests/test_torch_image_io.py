"""The port's image codec (ingp_tpu_torch/data/image_io.py) against the
libraries the JAX loaders call: read_png against imageio.v2.imread on
files PIL and OpenCV write and on hand-written ones (every filter type,
8 and 16 bit, gray, gray + alpha, RGB, RGBA, palette), the C++ unfilter
against its plain version, write_png and write_pgm round trips,
read_pgm against imageio,
resize_linear against cv2.resize (INTER_LINEAR, to 5e-7) and
resize_nearest against INTER_NEAREST (equal), and the refused formats."""
import struct
import zlib

import cv2
import imageio.v2 as imageio
import numpy as np
import pytest
from PIL import Image

from ingp_tpu_torch.data import image_io as io
from tests._torch_threads import one_torch_thread  # noqa: F401

RNG = np.random.default_rng(0)
# cv2's linear resize orders its float32 sums otherwise (a few float32
# ulps); a half-pixel or edge-clamp slip moves pixels by ~1e-2
LINEAR_TOL = 5e-7
RESIZES = [((800, 800), (400, 400)), ((800, 800), (16, 16)),
           ((1920, 1080), (960, 540)), ((53, 37), (80, 61)),
           ((768, 576), (307, 230)), ((64, 48), (64, 48)),
           ((100, 100), (33, 77))]


def _pixels(shape, dtype=np.uint8):
    hi = 256 if dtype == np.uint8 else 65536
    return RNG.integers(0, hi, shape).astype(dtype)


def _smooth(h, w, c):
    """An image whose rows PIL's adaptive filter encodes with Sub and
    Paeth."""
    yy, xx = np.mgrid[:h, :w]
    planes = [(xx * 3 + yy) % 256, (np.sin(xx / 5) * 90 + 120),
              (yy * 7) % 256, ((xx - w / 2) ** 2 + (yy - h / 2) ** 2
                               < (h / 3) ** 2) * 255]
    return np.stack(planes[:c], -1).astype(np.uint8)


def _filters(path):
    """The filter type of every row of a PNG file."""
    data = open(path, "rb").read()
    w, h, depth, ctype, _ = io._header(data, path)
    raw = zlib.decompress(b"".join(b for k, b in io._chunks(data, path)
                                   if k == b"IDAT"))
    row = w * io.CHANNELS[ctype] * depth // 8 + 1
    return np.frombuffer(raw, np.uint8)[::row][:h]


def _raw_png(path, arr, ctype, depth, interlace=0, types=0):
    """A PNG written by hand, its rows filtered by `types` (one filter
    type, or one per row) through io.filter_rows: every filter type,
    16-bit colour and interlace flags, which PIL does not write."""
    h, w = arr.shape[:2]
    be = arr.astype(">u2") if depth == 16 else arr.astype(np.uint8)
    rows = be.reshape(h, -1).view(np.uint8).reshape(h, -1)
    bpp = (arr.shape[2] if arr.ndim == 3 else 1) * depth // 8
    data = io.filter_rows(rows, bpp, types)

    def chunk(t, d):
        return struct.pack(">I", len(d)) + t + d + struct.pack(
            ">I", zlib.crc32(t + d))
    with open(path, "wb") as f:
        f.write(io.PNG_SIGNATURE + chunk(b"IHDR", struct.pack(
            ">IIBBBBB", w, h, depth, ctype, 0, 0, interlace))
            + chunk(b"IDAT", zlib.compress(data)) + chunk(b"IEND", b""))


def _same(path):
    ref, got = imageio.imread(path), io.read_png(path)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    return got


@pytest.mark.parametrize("mode,c", [("L", 1), ("LA", 2), ("RGB", 3),
                                    ("RGBA", 4)])
def test_read_png_matches_imageio_on_pil_files(tmp_path, mode, c):
    for img in (_smooth(40, 37, 4)[..., :c], _pixels((23, 19, c))):
        path = tmp_path / f"{mode}.png"
        Image.fromarray(img[..., 0] if c == 1 else img, mode).save(path)
        _same(path)
    if c == 4:  # PIL's adaptive filter chose Sub and Paeth rows (the
        # hand-written files below cover every type)
        Image.fromarray(_smooth(40, 37, 4)).save(tmp_path / "f.png")
        assert set(_filters(tmp_path / "f.png")) >= {1, 4}


@pytest.mark.parametrize("c", [1, 2, 3, 4])
@pytest.mark.parametrize("filt", [0, 1, 2, 3, 4, "mixed"])
def test_read_png_every_filter_type(tmp_path, c, filt):
    img = _pixels((13, 11, c))
    types = [0, 1, 2, 3, 4, 4, 3, 2, 1, 0, 3, 4, 1] if filt == "mixed" \
        else filt
    path = tmp_path / "f.png"
    _raw_png(path, img, {1: 0, 2: 4, 3: 2, 4: 6}[c], 8, types=types)
    assert list(_filters(path)) == list(np.broadcast_to(types, (13,)))
    np.testing.assert_array_equal(_same(path).reshape(13, 11, c), img)


@pytest.mark.parametrize("c", [1, 3, 4])
def test_write_png_paeth_rows_read_back_in_imageio(tmp_path, c):
    img = _pixels((13, 11, c))
    path = tmp_path / "w.png"
    io.write_png(path, img[..., 0] if c == 1 else img)
    assert set(_filters(path)) == {4}
    np.testing.assert_array_equal(_same(path).reshape(13, 11, c), img)


def test_read_png_16_bit_and_palette(tmp_path):
    g16 = _pixels((20, 17), np.uint16)
    Image.fromarray(g16).save(tmp_path / "g16.png")
    assert _same(tmp_path / "g16.png").dtype == np.uint16
    cv2.imwrite(str(tmp_path / "rgb16.png"), _pixels((9, 7, 3), np.uint16))
    cv2.imwrite(str(tmp_path / "rgba16.png"), _pixels((9, 7, 4), np.uint16))
    _same(tmp_path / "rgb16.png")
    _same(tmp_path / "rgba16.png")
    _raw_png(tmp_path / "ga16.png", _pixels((5, 6, 2), np.uint16), 4, 16)
    assert _same(tmp_path / "ga16.png").shape == (5, 6, 4)
    pal = Image.fromarray(_pixels((20, 20, 3))).quantize(256)
    pal.save(tmp_path / "p8.png")
    pal.save(tmp_path / "p8t.png", transparency=3)
    for name in ("p8.png", "p8t.png"):
        np.testing.assert_array_equal(_same(tmp_path / name),
                                      np.asarray(pal.convert("RGB")))
    Image.fromarray(_pixels((6, 5, 3))).save(tmp_path / "t.png",
                                             transparency=(1, 2, 3))
    _same(tmp_path / "t.png")
    assert io.image_size(tmp_path / "g16.png") == (17, 20)


def test_unfilter_helper_equals_plain_version(tmp_path):
    for c in (1, 2, 3, 4):
        img = _pixels((17, 9, c))
        types = RNG.integers(0, 5, 17)
        raw = io.filter_rows(img.reshape(17, -1), c, types)
        np.testing.assert_array_equal(io.unfilter(raw, 17, 9 * c, c),
                                      io.unfilter_plain(raw, 17, 9 * c, c))
        np.testing.assert_array_equal(io.unfilter(raw, 17, 9 * c, c),
                                      img.reshape(17, -1))
    # 16-bit samples: 2 bytes per channel
    img = _pixels((8, 5, 3), np.uint16).astype(">u2").view(np.uint8)
    raw = io.filter_rows(img.reshape(8, -1), 6, [4, 3, 1, 2, 4, 4, 3, 0])
    np.testing.assert_array_equal(io.unfilter(raw, 8, 30, 6),
                                  io.unfilter_plain(raw, 8, 30, 6))
    bad = bytearray(raw)
    bad[31 * 2] = 7
    for fn in (io.unfilter, io.unfilter_plain):
        with pytest.raises(ValueError, match="row 2: unknown filter"):
            fn(bytes(bad), 8, 30, 6)


def test_pgm_reads_and_writes_match_imageio(tmp_path):
    for dtype in (np.uint8, np.uint16):
        img = _pixels((7, 5), dtype)
        cv2.imwrite(str(tmp_path / "cv.pgm"), img)
        io.write_pgm(tmp_path / "own.pgm", img)
        for name in ("cv.pgm", "own.pgm"):
            got = io.read_pgm(tmp_path / name)
            assert got.dtype == dtype
            np.testing.assert_array_equal(got, imageio.imread(
                tmp_path / name))
    (tmp_path / "c.pgm").write_bytes(b"P5\n# a comment\n3 2\n255\n"
                                     + bytes(range(6)))
    np.testing.assert_array_equal(io.read_pgm(tmp_path / "c.pgm"),
                                  imageio.imread(tmp_path / "c.pgm"))


@pytest.mark.parametrize("src,dst", RESIZES)
def test_resize_matches_cv2(src, dst):
    (W, H), (w, h) = src, dst
    for shape in ((H, W), (H, W, 1), (H, W, 3)):
        img = RNG.random(shape, dtype=np.float32)
        ref = cv2.resize(img, (w, h))
        got = io.resize_linear(img, (w, h))
        assert got.shape == ref.shape and got.dtype == np.float32
        assert np.abs(got - ref).max() <= LINEAR_TOL
    labels = RNG.integers(0, 7, (H, W)).astype(np.uint16)
    np.testing.assert_array_equal(
        io.resize_nearest(labels, (w, h)),
        cv2.resize(labels, (w, h), interpolation=cv2.INTER_NEAREST))


def test_refused_formats_raise_by_name(tmp_path):
    Image.fromarray(_pixels((6, 6, 3))).save(tmp_path / "a.jpg",
                                             progressive=True)
    with pytest.raises(NotImplementedError, match="progressive JPEG"):
        io.read_jpeg(tmp_path / "a.jpg")
    with pytest.raises(NotImplementedError, match="progressive JPEG"):
        io.imread(tmp_path / "a.jpg")
    assert io.image_size(tmp_path / "a.jpg") == (6, 6)
    with pytest.raises(ValueError, match="not a PNG file .a JPEG"):
        io.read_png(tmp_path / "a.jpg")
    Image.fromarray(_pixels((6, 6, 3))).quantize(16).save(tmp_path / "p4.png")
    with pytest.raises(NotImplementedError, match="bit depth 4"):
        io.read_png(tmp_path / "p4.png")
    _raw_png(tmp_path / "i.png", _pixels((4, 4, 3)), 2, 8, interlace=1)
    with pytest.raises(NotImplementedError, match="Adam7"):
        io.read_png(tmp_path / "i.png")
    with pytest.raises(ValueError, match="float32"):
        io.resize_linear(_pixels((4, 4)), (2, 2))
