"""The port's JPEG codec and Lanczos resize (ingp_tpu_torch/data/image_io.py)
against PIL, the library under the JAX loaders' JPEG reads
(`imageio.imread`, `Image.open(...).convert("RGB")`) and Mega-NeRF's
resize (`Image.resize(..., LANCZOS)`): read_jpeg bit for bit on a grid of
files PIL and cv2 write (sizes, 4:4:4 / 4:2:2 / 4:2:0 / 4:4:0, quality,
optimised Huffman tables, restart intervals, gray, 16-bit quantisation
tables, an Adobe RGB file), the C++ helper against decode_jpeg_plain on
the same files, image_size, the refused formats by name, write_jpeg read
back by PIL, and resize_lanczos bit for bit."""
import io as pyio
import shutil

import cv2
import numpy as np
import pytest
from PIL import Image

from ingp_tpu_torch.data import image_io as io
from tests._torch_threads import one_torch_thread  # noqa: F401

# (h, w); the 1-wide-chroma case (w 2) takes libjpeg's box upsampling
SIZES = [(1, 1), (6, 8), (17, 33), (37, 53), (64, 48), (9, 2)]
SUBSAMPLING = {"4:4:4": 0, "4:2:2": 1, "4:2:0": 2}
CV2_SAMPLING = {"4:4:0": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
                "4:2:2": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
                "4:2:0": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
                "4:4:4": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444}
# write_jpeg's PSNR against _image's smooth field at quality 95 (measured
# 40.7-52.9 dB at 4:4:4, 37.2-37.8 at 4:2:0 from 17x33 up). At 4:2:0 it is
# checked only from 16 px a side: the field's chroma turns within a few
# pixels, so the 2x2 chroma average costs the 9x2 and 6x8 images 26.6 and
# 31.7 dB
ENCODE_PSNR = {"4:4:4": 38.0, "4:2:0": 35.0}


def _image(h, w, seed=0, noise=20.0):
    """A smooth RGB field plus noise: every block has AC terms."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    img = np.stack([128 + 100 * np.sin(xx / 5.0 + yy / 7.0),
                    128 + 90 * np.cos(yy / 3.0),
                    255 * (xx + yy) / (h + w)], -1)
    return np.clip(img + rng.normal(0, noise, (h, w, 3)), 0,
                   255).astype(np.uint8)


def _pil_jpeg(img, **kw) -> bytes:
    buf = pyio.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", **kw)
    return buf.getvalue()


def _cv2_jpeg(img, sampling, restart=0, quality=90) -> bytes:
    ok, enc = cv2.imencode(".jpg", img[..., ::-1], [
        cv2.IMWRITE_JPEG_QUALITY, quality,
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR, CV2_SAMPLING[sampling],
        cv2.IMWRITE_JPEG_RST_INTERVAL, restart])
    assert ok
    return enc.tobytes()


def _pil(data: bytes) -> np.ndarray:
    im = Image.open(pyio.BytesIO(data))
    return np.asarray(im if im.mode == "L" else im.convert("RGB"))


def _check(data: bytes, tmp_path=None):
    """read_jpeg_bytes equals PIL's decode and decode_jpeg_plain; with
    tmp_path, read_jpeg, imread and image_size on the file too."""
    ref = _pil(data)
    got = io.read_jpeg_bytes(data)
    assert got.dtype == np.uint8 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(io.decode_jpeg_plain(data), got)
    if tmp_path is not None:
        path = tmp_path / "x.jpg"
        path.write_bytes(data)
        np.testing.assert_array_equal(io.read_jpeg(path), ref)
        np.testing.assert_array_equal(io.imread(path), ref)
        assert io.image_size(path) == Image.open(path).size


@pytest.mark.parametrize("quality", [50, 90, 100])
@pytest.mark.parametrize("sub", list(SUBSAMPLING))
@pytest.mark.parametrize("hw", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_read_jpeg_equals_pil(tmp_path, hw, sub, quality):
    _check(_pil_jpeg(_image(*hw), quality=quality,
                     subsampling=SUBSAMPLING[sub]), tmp_path)


@pytest.mark.parametrize("sub", list(SUBSAMPLING))
@pytest.mark.parametrize("hw", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_read_jpeg_optimized_tables_and_gray(hw, sub):
    img = _image(*hw, seed=1)
    _check(_pil_jpeg(img, quality=85, subsampling=SUBSAMPLING[sub],
                     optimize=True))
    _check(_pil_jpeg(img[..., SUBSAMPLING[sub]], quality=85))


@pytest.mark.parametrize("sampling,restart", [
    ("4:4:0", 0), ("4:4:0", 2), ("4:2:0", 1), ("4:2:2", 3), ("4:4:4", 5)])
@pytest.mark.parametrize("hw", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_read_jpeg_cv2_sampling_and_restarts(hw, sampling, restart):
    data = _cv2_jpeg(_image(*hw, seed=2), sampling, restart)
    if restart and hw[0] * hw[1] > 64:
        assert b"\xff\xdd" in data and b"\xff\xd0" in data
    _check(data)


def test_read_jpeg_16bit_tables_adobe_rgb_and_fill_bytes():
    img = _image(37, 53, seed=3)
    # a quantisation value above 255 makes libjpeg write a 16-bit DQT and
    # an extended-sequential (SOF1) frame
    data = _pil_jpeg(img, qtables=[list(range(1, 65)), [300] * 64])
    assert b"\xff\xc1" in data
    _check(data)
    # an Adobe APP14 with transform 0 in place of JFIF: the components
    # are RGB, not converted
    data = _pil_jpeg(img, quality=90, subsampling=0)
    app0 = data.index(b"\xff\xe0")
    n = int.from_bytes(data[app0 + 2:app0 + 4], "big")
    adobe = b"\xff\xee\x00\x0eAdobe\x00\x64\x00\x00\x00\x00\x00"
    rgb = data[:app0] + adobe + data[app0 + 2 + n:]
    assert Image.open(pyio.BytesIO(rgb)).info.get("adobe_transform") == 0
    _check(rgb)
    # fill bytes before every marker after the frame
    sof = data.index(b"\xff\xc0")
    padded = data[:sof] + data[sof:].replace(b"\xff\xc4", b"\xff\xff\xff\xc4")
    _check(padded)


def _patched(data: bytes, offset_from_sof: int, value: int) -> bytes:
    sof = data.index(b"\xff\xc0")
    b = bytearray(data)
    b[sof + offset_from_sof] = value
    return bytes(b)


def test_refused_jpegs_raise_by_name(tmp_path):
    img = _image(17, 33)
    buf = pyio.BytesIO()
    Image.fromarray(img).convert("CMYK").save(buf, "JPEG")
    base = _pil_jpeg(img, quality=90)
    cases = [(_pil_jpeg(img, progressive=True), "progressive JPEG"),
             (buf.getvalue(), "4-component .CMYK / YCCK. JPEG"),
             (_patched(base, 1, 0xC3), "lossless JPEG"),
             (_patched(base, 1, 0xC9), "arithmetic-coded JPEG"),
             (_patched(base, 4, 12), "12-bit JPEG samples")]
    for data, name in cases:
        with pytest.raises(NotImplementedError, match=name):
            io.read_jpeg_bytes(data)
        with pytest.raises(NotImplementedError, match=name):
            io.decode_jpeg_plain(data)
    # the size of what read_jpeg refuses still reads from its frame
    (tmp_path / "p.jpg").write_bytes(cases[0][0])
    assert io.image_size(tmp_path / "p.jpg") == (33, 17)
    with pytest.raises(ValueError, match="not a PNG file .a JPEG"):
        io.read_png(tmp_path / "p.jpg")
    with pytest.raises(ValueError, match="corrupt JPEG: entropy-coded"):
        io.read_jpeg_bytes(base[:len(base) * 2 // 3])
    with pytest.raises(ValueError, match="corrupt JPEG: entropy-coded"):
        io.decode_jpeg_plain(base[:len(base) * 2 // 3])


def test_no_helper_no_decode(tmp_path, monkeypatch):
    """Without g++ read_jpeg raises; it never falls back to the plain
    version."""
    data = _pil_jpeg(_image(8, 8))
    monkeypatch.setattr(io, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(shutil, "which", lambda name: None)
    io.load_helper.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="g.. not found: the JPEG"):
            io.read_jpeg_bytes(data)
    finally:
        io.load_helper.cache_clear()


@pytest.mark.parametrize("quality", [50, 95])
@pytest.mark.parametrize("sub", ["4:4:4", "4:2:0"])
@pytest.mark.parametrize("hw", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_write_jpeg_reads_back(tmp_path, hw, sub, quality):
    """PIL reads write_jpeg's file as read_jpeg does; at quality 95 within
    ENCODE_PSNR of the source (a smooth field with little noise)."""
    img = _image(*hw, seed=4, noise=2.0)
    path = tmp_path / "w.jpg"
    io.write_jpeg(path, img, quality, sub)
    got = io.read_jpeg(path)
    np.testing.assert_array_equal(got, np.asarray(Image.open(path)))
    np.testing.assert_array_equal(io.decode_jpeg_plain(path.read_bytes()),
                                  got)
    if quality == 95 and (sub == "4:4:4" or min(hw) >= 16):
        mse = ((got.astype(np.float64) - img) ** 2).mean()
        assert 10 * np.log10(255 ** 2 / max(mse, 1e-12)) >= ENCODE_PSNR[sub]
    io.write_jpeg(path, img[..., 1], quality)
    np.testing.assert_array_equal(io.read_jpeg(path),
                                  np.asarray(Image.open(path)))


# (source (h, w), target (w, h)): shrinks by 2 and 4, a non-integer
# factor, an enlargement, odd sizes, one axis unchanged, one pixel
LANCZOS = [((64, 48), (24, 32)), ((64, 48), (12, 16)), ((37, 53), (19, 13)),
           ((17, 33), (71, 40)), ((61, 47), (29, 23)), ((40, 30), (30, 13)),
           ((40, 30), (11, 40)), ((9, 7), (1, 1)), ((1, 1), (5, 3)),
           ((864, 1152), (288, 216))]


@pytest.mark.parametrize("src,dst", LANCZOS,
                         ids=lambda v: "x".join(map(str, v)))
def test_resize_lanczos_equals_pil(src, dst):
    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, src + (3,), dtype=np.uint8)
    for im in (img, img[..., 0]):
        ref = np.asarray(Image.fromarray(im).resize(dst, Image.LANCZOS))
        got = io.resize_lanczos(im, dst)
        assert got.dtype == np.uint8 and got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)
    with pytest.raises(ValueError, match="uint8"):
        io.resize_lanczos(img.astype(np.float32), dst)
