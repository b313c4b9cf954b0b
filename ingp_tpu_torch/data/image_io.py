"""The port's image codec, in numpy and the standard library (zlib,
struct): the reads and resizes that the JAX loaders make through
`imageio.v2.imread`, `cv2.imread`, `cv2.resize` and `PIL.Image.open(...)
.size`, none of which the port needs installed.

  read_png        non-interlaced PNG, bit depth 8 and 16; gray, gray +
                  alpha, RGB, RGBA and palette: what imageio.v2.imread
                  returns for the same file
  read_pgm        binary PGM (P5), 8 and 16 bit, big-endian
  read_u8         what cv2.imread(path) (BGR -> RGB) or, with gray,
                  cv2.imread(path, IMREAD_GRAYSCALE) gives for a PNG or
                  PGM: 8 bits per sample (16-bit samples shifted right by
                  8), colour as RGB, gray as one channel
  image_size      (width, height) from a PNG header
  write_png       8-bit gray, RGB and RGBA, Paeth-filtered rows
  write_pgm       binary PGM (P5), 8 and 16 bit
  resize_linear   cv2.resize(img, (w, h)) (INTER_LINEAR) on float32
  resize_linear_u8  the same on uint8, OpenCV's fixed-point arithmetic
  resize_nearest  cv2.resize(img, (w, h), interpolation=INTER_NEAREST)

PNG rows are unfiltered by a small C++ helper (csrc/png_unfilter.cpp),
which g++ builds at first use into data/_build/ (git-ignored) and ctypes
binds; `unfilter_plain` is its numpy version. Where the helper cannot be
built, read_png raises: it never decodes with the plain version, which
loops over the pixels of Average and Paeth rows in Python (seconds for
one 800x800 image).

Refused by name (NotImplementedError): Adam7 interlacing, bit depths
below 8 and JPEG files.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import struct
import subprocess
import zlib
from pathlib import Path

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
JPEG_SIGNATURE = b"\xff\xd8\xff"
# channels of each PNG colour type: gray, RGB, palette, gray + alpha, RGBA
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
HELPER_SRC = Path(__file__).resolve().parent / "csrc" / "png_unfilter.cpp"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
GXX_TIMEOUT_S = 120


# -- the unfilter helper ----------------------------------------------------

def helper_path() -> Path:
    """The helper's library, named by a hash of its source."""
    digest = hashlib.sha256(HELPER_SRC.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libingp_png-{digest}.so"


def build_helper() -> Path:
    """Compile csrc/png_unfilter.cpp with g++ into helper_path(); raise
    RuntimeError when g++ is missing or fails."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the PNG reader's unfilter "
                           "helper (data/csrc/png_unfilter.cpp) needs it")
    out = helper_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [gxx, "-O3", "-shared", "-fPIC", "-o", str(tmp), str(HELPER_SRC)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True,
                       timeout=GXX_TIMEOUT_S)
    except subprocess.CalledProcessError as e:
        raise RuntimeError(f"g++ failed (exit {e.returncode}) on "
                           f"{HELPER_SRC}:\n{e.stderr}") from e
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def load_helper() -> ctypes.CDLL:
    """The unfilter helper, built first if its source has no library."""
    path = helper_path()
    if not path.exists():
        build_helper()
    lib = ctypes.CDLL(str(path))
    lib.ingp_png_unfilter.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                      ctypes.c_int64, ctypes.c_int64,
                                      ctypes.c_int64]
    lib.ingp_png_unfilter.restype = ctypes.c_int64
    return lib


def _check_stream(raw, height, row_bytes):
    if len(raw) != height * (row_bytes + 1):
        raise ValueError(f"PNG data holds {len(raw)} bytes, expected "
                         f"{height} rows of 1 + {row_bytes}")


def unfilter(raw: bytes, height: int, row_bytes: int, bpp: int
             ) -> np.ndarray:
    """Undo the PNG row filters of a decompressed image stream (each row
    one filter-type byte, then row_bytes bytes; bpp bytes per pixel, at
    least 1) with the C++ helper. Returns (height, row_bytes) uint8."""
    _check_stream(raw, height, row_bytes)
    src = np.frombuffer(raw, np.uint8)
    out = np.empty((height, row_bytes), np.uint8)
    bad = load_helper().ingp_png_unfilter(
        src.ctypes.data, out.ctypes.data, height, row_bytes, bpp)
    if bad:
        raise ValueError(f"PNG row {bad - 1}: unknown filter type "
                         f"{raw[(bad - 1) * (row_bytes + 1)]}")
    return out


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def unfilter_plain(raw: bytes, height: int, row_bytes: int, bpp: int
                   ) -> np.ndarray:
    """unfilter in numpy: Sub as a wrapping sum along each byte lane, Up
    as a row add, Average and Paeth byte by byte in Python."""
    _check_stream(raw, height, row_bytes)
    rows = np.frombuffer(raw, np.uint8).reshape(height, row_bytes + 1)
    out = np.zeros((height, row_bytes), np.uint8)
    prev = np.zeros(row_bytes, np.int64)
    for y in range(height):
        kind, x = rows[y, 0], rows[y, 1:].astype(np.int64)
        if kind == 0:
            row = x
        elif kind == 1:  # row_bytes is a whole number of pixels
            row = np.cumsum(x.reshape(-1, bpp), 0).reshape(-1)
        elif kind == 2:
            row = x + prev
        elif kind in (3, 4):
            row = x.copy()
            for i in range(row_bytes):
                a = row[i - bpp] & 255 if i >= bpp else 0
                c = prev[i - bpp] if i >= bpp else 0
                row[i] += (a + prev[i]) >> 1 if kind == 3 else \
                    int(_paeth(a, prev[i], c))
        else:
            raise ValueError(f"PNG row {y}: unknown filter type {kind}")
        out[y] = row & 255
        prev = out[y].astype(np.int64)
    return out


# -- reading ---------------------------------------------------------------

def _read_bytes(path) -> bytes:
    with open(path, "rb") as f:
        data = f.read()
    if data.startswith(JPEG_SIGNATURE):
        raise NotImplementedError(
            f"{path}: JPEG decoding is not ported yet (ROADMAP.md Queue 1 "
            f"item 7); the port reads PNG")
    if not data.startswith(PNG_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    return data


def _chunks(data: bytes, path):
    """(type, payload) of each chunk after the signature, CRC-checked, up
    to IEND."""
    pos = len(PNG_SIGNATURE)
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 4:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(body) != crc:
            raise ValueError(f"{path}: bad CRC in chunk {kind!r}")
        yield kind, body[4:]
        if kind == b"IEND":
            return
        pos += 12 + n
    raise ValueError(f"{path}: truncated PNG (no IEND chunk)")


def _header(data: bytes, path):
    """(width, height, bit depth, colour type, interlace) of IHDR."""
    if data[12:16] != b"IHDR":
        raise ValueError(f"{path}: PNG without IHDR first")
    w, h, depth, ctype, _, _, interlace = struct.unpack(">IIBBBBB",
                                                        data[16:29])
    return w, h, depth, ctype, interlace


def image_size(path) -> tuple[int, int]:
    """(width, height) of a PNG, from its header (PIL's Image.open(path)
    .size)."""
    w, h, *_ = _header(_read_bytes(path), path)
    return w, h


def read_png(path) -> np.ndarray:
    """Decode a PNG as imageio.v2.imread does (through PIL): (H, W) for
    gray, (H, W, 2) gray + alpha, (H, W, 3) RGB and palette (looked up,
    tRNS ignored, as imageio ignores it everywhere), (H, W, 4) RGBA;
    uint8, but 16-bit gray is uint16 and 16-bit colour comes back as the
    high bytes of its samples in uint8, 16-bit gray + alpha as RGBA (gray
    repeated), as PIL reduces them."""
    data = _read_bytes(path)
    w, h, depth, ctype, interlace = _header(data, path)
    if interlace:
        raise NotImplementedError(f"{path}: Adam7-interlaced PNG is not "
                                  f"supported")
    if depth < 8:
        raise NotImplementedError(f"{path}: PNG bit depth {depth} (below "
                                  f"8) is not supported")
    if ctype not in CHANNELS or depth not in (8, 16) or (
            ctype == 3 and depth != 8):
        raise ValueError(f"{path}: invalid PNG colour type {ctype} at bit "
                         f"depth {depth}")
    idat, palette = [], None
    for kind, body in _chunks(data, path):
        if kind == b"IDAT":
            idat.append(body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
    c = CHANNELS[ctype]
    bpp = c * depth // 8
    px = unfilter(zlib.decompress(b"".join(idat)), h, w * bpp, bpp)
    if depth == 16:
        px = px.view(">u2").reshape(h, w, c)
        if ctype == 0:
            return px[..., 0].astype(np.uint16)
        high = (px >> 8).astype(np.uint8)
        return high[..., [0, 0, 0, 1]] if ctype == 4 else high
    px = px.reshape(h, w, c)
    if ctype == 3:
        if palette is None or int(px.max(initial=0)) >= len(palette):
            raise ValueError(f"{path}: palette index outside PLTE")
        return palette[px[..., 0]]
    return px[..., 0] if c == 1 else px


def read_pgm(path) -> np.ndarray:
    """A binary PGM (P5) as (H, W): uint8 where maxval < 256, else
    big-endian 16-bit samples as uint16 (imageio gives them as int32,
    equal in value)."""
    with open(path, "rb") as f:
        data = f.read()
    fields, pos = [], 0
    while len(fields) < 4:
        while data[pos:pos + 1].isspace():
            pos += 1
        if data[pos:pos + 1] == b"#":
            pos = data.index(b"\n", pos)
            continue
        end = pos
        while end < len(data) and not data[end:end + 1].isspace():
            end += 1
        fields.append(data[pos:end])
        pos = end
    if fields[0] != b"P5":
        raise ValueError(f"{path}: not a binary PGM (P5)")
    w, h, maxval = (int(v) for v in fields[1:])
    dtype = np.dtype(np.uint8) if maxval < 256 else np.dtype(">u2")
    pos += 1  # the single whitespace after maxval
    n = w * h * dtype.itemsize
    if len(data) < pos + n:
        raise ValueError(f"{path}: truncated PGM")
    img = np.frombuffer(data[pos:pos + n], dtype).reshape(h, w)
    return img.astype(np.uint8 if maxval < 256 else np.uint16)


def read_u8(path, gray: bool = False) -> np.ndarray:
    """An 8-bit PNG or PGM as cv2.imread reads it: (H, W, 3) RGB (the
    channel order of cv2.imread + COLOR_BGR2RGB; gray expanded, alpha
    dropped) or, with gray, (H, W) (cv2.IMREAD_GRAYSCALE). 16-bit samples
    keep their high byte, as OpenCV converts them. A colour image read as
    gray raises: cv2 would mix its channels, which no loader here asks
    for."""
    img = read_pgm(path) if str(path).lower().endswith(".pgm") \
        else read_png(path)
    if img.dtype == np.uint16:
        img = (img >> 8).astype(np.uint8)
    if gray:
        if img.ndim == 3:
            raise ValueError(f"{path}: a {img.shape[2]}-channel image read "
                             f"as gray")
        return img
    if img.ndim == 2:
        return np.repeat(img[..., None], 3, 2)
    if img.shape[2] == 2:             # gray + alpha
        return np.repeat(img[..., :1], 3, 2)
    return np.ascontiguousarray(img[..., :3])


# -- writing ---------------------------------------------------------------

def filter_rows(px: np.ndarray, bpp: int, types) -> bytes:
    """Filter (H, row_bytes) uint8 rows for the PNG stream: types is one
    filter type 0-4 for every row or one per row. Vectorised: every
    filter reads only the original bytes."""
    h, n = px.shape
    types = np.broadcast_to(np.asarray(types, np.uint8), (h,))
    if types.max(initial=0) > 4:
        raise ValueError(f"PNG filter types are 0-4, not {types.max()}")
    x = px.astype(np.int16)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]
    pred = np.stack([np.zeros_like(x), a, b, (a + b) >> 1,
                     _paeth(a, b, c)])[types, np.arange(h)]
    out = np.empty((h, n + 1), np.uint8)
    out[:, 0] = types
    out[:, 1:] = (x - pred) & 255
    return out.tobytes()


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def write_png(path, img: np.ndarray) -> None:
    """Write uint8 (H, W) gray, (H, W, 3) RGB or (H, W, 4) RGBA as an
    8-bit PNG, every row Paeth-filtered (as Blender's frames mostly
    are)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"write_png takes uint8, not {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    ctype = {1: 0, 3: 2, 4: 6}.get(img.shape[-1] if img.ndim == 3 else 0)
    if ctype is None:
        raise ValueError(f"write_png takes (H, W), (H, W, 3) or (H, W, 4), "
                         f"not {img.shape}")
    h, w, c = img.shape
    rows = filter_rows(np.ascontiguousarray(img).reshape(h, w * c), c, 4)
    with open(path, "wb") as f:
        f.write(PNG_SIGNATURE
                + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype,
                                              0, 0, 0))
                + _chunk(b"IDAT", zlib.compress(rows, 6))
                + _chunk(b"IEND", b""))


def write_pgm(path, img: np.ndarray) -> None:
    """Write uint8 or uint16 (H, W) as a binary PGM (P5; 16 bit
    big-endian, maxval 65535)."""
    img = np.asarray(img)
    if img.ndim != 2 or img.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"write_pgm takes uint8 or uint16 (H, W), not "
                         f"{img.dtype} {img.shape}")
    maxval = 255 if img.dtype == np.uint8 else 65535
    h, w = img.shape
    with open(path, "wb") as f:
        f.write(f"P5\n{w} {h}\n{maxval}\n".encode()
                + img.astype(img.dtype.newbyteorder(">")).tobytes())


# -- resizing --------------------------------------------------------------

def _linear_taps(src: int, dst: int):
    """OpenCV's INTER_LINEAR taps along one axis: x = (d + 0.5) * scale -
    0.5 in double, s = floor(x), weight x - s on s + 1; clamped at both
    edges with zero weight on the far tap."""
    scale = 1.0 / (dst / src)
    x = (np.arange(dst) + 0.5) * scale - 0.5
    s = np.floor(x).astype(np.int64)
    f = x - s
    f[s < 0] = 0.0
    s[s < 0] = 0
    f[s >= src - 1] = 0.0
    s[s >= src - 1] = src - 1
    f = f.astype(np.float32)
    return s, np.minimum(s + 1, src - 1), 1.0 - f, f


def _drop_single_channel(img, out):
    # cv2.resize returns a (H, W, 1) image as (h, w)
    return out[..., 0] if img.ndim == 3 and img.shape[2] == 1 else out


def resize_linear(img: np.ndarray, wh) -> np.ndarray:
    """cv2.resize(img, wh) with INTER_LINEAR on a float32 (H, W) or
    (H, W, C) image: rows interpolated first, then columns, in float32
    (within ~2e-7 of OpenCV's, which orders its float sums otherwise)."""
    if img.dtype != np.float32:
        raise ValueError(f"resize_linear takes float32, not {img.dtype}")
    w, h = (int(v) for v in wh)
    H, W = img.shape[:2]
    if (w, h) == (W, H):
        return _drop_single_channel(img, img.copy())
    x0, x1, a0, a1 = _linear_taps(W, w)
    y0, y1, b0, b1 = _linear_taps(H, h)
    col = (slice(None),) + (None,) * (img.ndim - 2)
    top, bot = img[y0], img[y1]
    r0 = top[:, x0] * a0[col] + top[:, x1] * a1[col]
    r1 = bot[:, x0] * a0[col] + bot[:, x1] * a1[col]
    row = (slice(None),) + (None,) * (img.ndim - 1)
    return _drop_single_channel(img, r0 * b0[row] + r1 * b1[row])


RESIZE_COEF_SCALE = 2048    # OpenCV's INTER_RESIZE_COEF_SCALE (11 bits)


def _linear_taps_u8(src: int, dst: int, clamp: bool = True):
    """_linear_taps' taps with OpenCV's fixed-point weights: the offset
    x is rounded to float32 before its floor, and each weight is
    round-half-even(w * 2048) of the float32 weight. Without clamp (the
    vertical axis) a tap outside the image keeps its weight and reads the
    edge row."""
    scale = 1.0 / (dst / src)
    x = ((np.arange(dst) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(x).astype(np.int64)
    f = (x - s.astype(np.float32)).astype(np.float32)
    if not clamp:
        a1 = np.rint(f * np.float32(RESIZE_COEF_SCALE)).astype(np.int64)
        a0 = np.rint((np.float32(1) - f) * np.float32(RESIZE_COEF_SCALE)
                     ).astype(np.int64)
        return np.clip(s, 0, src - 1), np.clip(s + 1, 0, src - 1), a0, a1
    f[s < 0] = 0.0
    s[s < 0] = 0
    f[s >= src - 1] = 0.0
    s[s >= src - 1] = src - 1
    a1 = np.rint(f * np.float32(RESIZE_COEF_SCALE)).astype(np.int64)
    a0 = np.rint((np.float32(1) - f) * np.float32(RESIZE_COEF_SCALE)
                 ).astype(np.int64)
    return s, np.minimum(s + 1, src - 1), a0, a1


def resize_linear_u8(img: np.ndarray, wh) -> np.ndarray:
    """cv2.resize(img, wh) with INTER_LINEAR on a uint8 (H, W) or (H, W,
    C) image, bit for bit: OpenCV's fixed-point form. The horizontal pass
    sums src * alpha in integers (alpha in 1/2048ths); the vertical pass
    takes each sum >> 4, multiplies it by beta and keeps the high 16 bits
    of the product, adds the two rows' terms and rounds >> 2 with +2
    (its vectorised VResizeLinearVec_32s8u, which the whole row takes),
    saturated to [0, 255]. Horizontal taps outside the image are clamped
    to the edge pixel at full weight; vertical ones keep their weights
    and read the edge row twice, as OpenCV does (which differs in the
    truncated bits when enlarging)."""
    if img.dtype != np.uint8:
        raise ValueError(f"resize_linear_u8 takes uint8, not {img.dtype}")
    w, h = (int(v) for v in wh)
    H, W = img.shape[:2]
    if (w, h) == (W, H):
        return _drop_single_channel(img, img.copy())
    x0, x1, a0, a1 = _linear_taps_u8(W, w)
    y0, y1, b0, b1 = _linear_taps_u8(H, h, clamp=False)
    x = img.reshape(H, W, -1).astype(np.int64)
    rows = x[:, x0] * a0[None, :, None] + x[:, x1] * a1[None, :, None]
    t0 = ((rows[y0] >> 4) * b0[:, None, None]) >> 16
    t1 = ((rows[y1] >> 4) * b1[:, None, None]) >> 16
    out = np.clip((t0 + t1 + 2) >> 2, 0, 255).astype(np.uint8)
    return out.reshape((h, w) + img.shape[2:]) if img.ndim == 3 \
        and img.shape[2] != 1 else out.reshape(h, w)


def _area_taps(src: int, dst: int) -> np.ndarray:
    """OpenCV's INTER_AREA weights along one axis as a (dst, src) float32
    matrix (computeResizeAreaTab): destination pixel d covers source
    [d * scale, (d + 1) * scale), each source pixel weighted by its
    overlap over the cell's width, overlaps of 1e-3 or less dropped."""
    scale = src / dst
    tab = np.zeros((dst, src), np.float32)
    for d in range(dst):
        f1 = d * scale
        f2 = f1 + scale
        width = min(scale, src - f1)
        s2 = min(int(np.floor(f2)), src - 1)
        s1 = min(int(np.ceil(f1)), s2)
        if s1 - f1 > 1e-3:
            tab[d, s1 - 1] = (s1 - f1) / width
        tab[d, s1:s2] = 1.0 / width
        if f2 - s2 > 1e-3:
            tab[d, s2] = min(min(f2 - s2, 1.0), width) / width
    return tab


def resize_area(img: np.ndarray, wh) -> np.ndarray:
    """cv2.resize(img, wh, interpolation=cv2.INTER_AREA) of a float32 (H,
    W) or (H, W, C) image to a size no larger on either axis: the mean of
    each k x k block when both factors are whole numbers k, else
    OpenCV's area-overlap weights, rows then columns (summed in float64
    where OpenCV sums in float32: within ~1e-7 of it)."""
    if img.dtype != np.float32:
        raise ValueError(f"resize_area takes float32, not {img.dtype}")
    w, h = (int(v) for v in wh)
    H, W = img.shape[:2]
    if w > W or h > H:
        raise ValueError(f"resize_area shrinks only: ({W}, {H}) -> ({w}, "
                         f"{h})")
    x = img.reshape(H, W, -1).astype(np.float64)
    C = x.shape[2]
    if W % w == 0 and H % h == 0:
        kx, ky = W // w, H // h
        out = x.reshape(h, ky, w, kx, C).sum((1, 3)) * (1.0 / (kx * ky))
    else:
        rows = _area_taps(H, h).astype(np.float64) @ x.reshape(H, W * C)
        out = np.einsum("xW,yWc->yxc", _area_taps(W, w).astype(np.float64),
                        rows.reshape(h, W, C))
    out = out.astype(np.float32)
    return out.reshape((h, w) + img.shape[2:]) if img.ndim == 3 \
        and img.shape[2] != 1 else out.reshape(h, w)


def resize_nearest(img: np.ndarray, wh) -> np.ndarray:
    """cv2.resize(img, wh, interpolation=cv2.INTER_NEAREST): source index
    floor(d * src / dst), as OpenCV computes it, capped at the last."""
    w, h = (int(v) for v in wh)
    H, W = img.shape[:2]
    sx = np.minimum(np.floor(np.arange(w) * (1.0 / (w / W))), W - 1)
    sy = np.minimum(np.floor(np.arange(h) * (1.0 / (h / H))), H - 1)
    out = img[sy.astype(np.int64)][:, sx.astype(np.int64)]
    return _drop_single_channel(img, out)
