"""The port's image codec, in numpy and the standard library (zlib,
struct) with two small C++ helpers: the reads and resizes that the JAX
loaders make through `imageio.v2.imread`, `cv2.imread`, `cv2.resize`,
`PIL.Image.open(...).convert("RGB")`, `PIL.Image.resize(..., LANCZOS)` and
`PIL.Image.open(...).size`, none of which the port needs installed.

  imread          a PNG, JPEG or binary PGM, told apart by its first bytes
                  (not its name), as imageio.v2.imread returns it
  read_png        non-interlaced PNG, bit depth 8 and 16; gray, gray +
                  alpha, RGB, RGBA and palette: what imageio.v2.imread
                  returns for the same file
  read_jpeg       baseline and extended-sequential Huffman JPEG (SOF0,
                  SOF1) at 8 bits, gray or three components, luma
                  sampled 1x1, 2x1, 1x2 or 2x2 over 1x1 chroma: PIL's
                  decode (libjpeg-turbo's islow IDCT, fancy upsampling and
                  fixed-point colour conversion) bit for bit
  read_pgm        binary PGM (P5), 8 and 16 bit, big-endian
  read_u8         what cv2.imread(path) (BGR -> RGB) or, with gray,
                  cv2.imread(path, IMREAD_GRAYSCALE) gives for a PNG,
                  JPEG or PGM: 8 bits per sample (16-bit samples shifted
                  right by 8), colour as RGB, gray as one channel
  image_size      (width, height) from a PNG header or a JPEG frame
  write_png       8-bit gray, RGB and RGBA, Paeth-filtered rows
  write_jpeg      baseline JPEG, gray or RGB at 4:4:4 or 4:2:0, with the
                  standard (Annex K) tables at libjpeg's quality scaling
  write_pgm       binary PGM (P5), 8 and 16 bit
  resize_linear   cv2.resize(img, (w, h)) (INTER_LINEAR) on float32
  resize_linear_u8  the same on uint8, OpenCV's fixed-point arithmetic
  resize_lanczos  PIL's Image.resize((w, h), LANCZOS) on 8-bit gray and
                  RGB, bit for bit
  resize_nearest  cv2.resize(img, (w, h), interpolation=INTER_NEAREST)

PNG rows are unfiltered by a small C++ helper (csrc/png_unfilter.cpp), and
a JPEG scan is entropy-decoded, transformed, upsampled and converted by
another (csrc/jpeg_decode.cpp). g++ builds each at first use into
data/_build/ (git-ignored), named by a hash of its source, and ctypes
binds it. `unfilter_plain` and `decode_jpeg_plain` are their numpy
versions. Where a helper cannot be built, read_png and read_jpeg raise:
they never decode with the plain versions, which loop over pixels (PNG)
or Huffman codes (JPEG) in Python: seconds for one 800x800 PNG, minutes
for a 16-Mpx JPEG.

Refused by name (NotImplementedError): Adam7 interlacing and bit depths
below 8 (PNG); progressive, lossless, hierarchical and arithmetic-coded
JPEG, 12-bit samples, other than one or three components (CMYK, YCCK),
other sampling factors and a scan per component.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import math
import os
import shutil
import struct
import subprocess
import zlib
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
JPEG_SIGNATURE = b"\xff\xd8\xff"
PGM_SIGNATURE = b"P5"
# channels of each PNG colour type: gray, RGB, palette, gray + alpha, RGBA
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
GXX_TIMEOUT_S = 120
# helper -> (source, the library's name stem)
HELPERS = {"png": (CSRC / "png_unfilter.cpp", "libingp_png"),
           "jpeg": (CSRC / "jpeg_decode.cpp", "libingp_jpeg")}
_i64, _ptr = ctypes.c_int64, ctypes.c_void_p
SIGNATURES = {"png": ("ingp_png_unfilter", [_ptr, _ptr, _i64, _i64, _i64]),
              "jpeg": ("ingp_jpeg_decode",
                       [_ptr, _i64, _i64, _i64, _i64, _ptr, _ptr, _ptr,
                        _ptr, _i64, _i64, _ptr])}


# -- the C++ helpers ----------------------------------------------------------

def helper_path(name: str = "png") -> Path:
    """The helper's library, named by a hash of its source."""
    src, stem = HELPERS[name]
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"{stem}-{digest}.so"


def build_helper(name: str = "png") -> Path:
    """Compile the helper's source (csrc/png_unfilter.cpp or
    csrc/jpeg_decode.cpp) with g++ into helper_path(name); raise
    RuntimeError when g++ is missing or fails."""
    src = HELPERS[name][0]
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError(f"g++ not found: the {name.upper()} reader's "
                           f"helper (data/csrc/{src.name}) needs it")
    out = helper_path(name)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [gxx, "-O3", "-shared", "-fPIC", "-o", str(tmp), str(src)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True,
                       timeout=GXX_TIMEOUT_S)
    except subprocess.CalledProcessError as e:
        raise RuntimeError(f"g++ failed (exit {e.returncode}) on "
                           f"{src}:\n{e.stderr}") from e
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def load_helper(name: str = "png") -> ctypes.CDLL:
    """The helper's library, built first if its source has none."""
    path = helper_path(name)
    if not path.exists():
        build_helper(name)
    lib = ctypes.CDLL(str(path))
    symbol, argtypes = SIGNATURES[name]
    fn = getattr(lib, symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int64
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

def _read_file(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _png_bytes(data: bytes, path) -> bytes:
    if not data.startswith(PNG_SIGNATURE):
        kind = " (a JPEG: read it with read_jpeg or imread)" \
            if data.startswith(JPEG_SIGNATURE) else ""
        raise ValueError(f"{path}: not a PNG file{kind}")
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
    """(width, height) of a PNG (its header) or a JPEG (its frame
    header), as PIL's Image.open(path).size."""
    data = _read_file(path)
    if data.startswith(JPEG_SIGNATURE):
        return _jpeg_size(data, path)
    w, h, *_ = _header(_png_bytes(data, path), path)
    return w, h


def read_png(path) -> np.ndarray:
    """Decode a PNG file as imageio.v2.imread does: see read_png_bytes."""
    return read_png_bytes(_read_file(path), path)


def read_png_bytes(data: bytes, name="<bytes>") -> np.ndarray:
    """Decode a PNG as imageio.v2.imread does (through PIL): (H, W) for
    gray, (H, W, 2) gray + alpha, (H, W, 3) RGB and palette (looked up,
    tRNS ignored, as imageio ignores it everywhere), (H, W, 4) RGBA;
    uint8, but 16-bit gray is uint16 and 16-bit colour comes back as the
    high bytes of its samples in uint8, 16-bit gray + alpha as RGBA (gray
    repeated), as PIL reduces them. name is the file named in errors."""
    data = _png_bytes(data, name)
    w, h, depth, ctype, interlace = _header(data, name)
    if interlace:
        raise NotImplementedError(f"{name}: Adam7-interlaced PNG is not "
                                  f"supported")
    if depth < 8:
        raise NotImplementedError(f"{name}: PNG bit depth {depth} (below "
                                  f"8) is not supported")
    if ctype not in CHANNELS or depth not in (8, 16) or (
            ctype == 3 and depth != 8):
        raise ValueError(f"{name}: invalid PNG colour type {ctype} at bit "
                         f"depth {depth}")
    idat, palette = [], None
    for kind, body in _chunks(data, name):
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
            raise ValueError(f"{name}: palette index outside PLTE")
        return palette[px[..., 0]]
    return px[..., 0] if c == 1 else px


# -- JPEG -------------------------------------------------------------------

# ZIGZAG[k]: the natural (row-major) index of the k-th coefficient in the
# zigzag order of the file
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])
# frame markers the decoder refuses, by what they start
JPEG_REFUSED = {0xC2: "progressive", 0xC3: "lossless",
                0xC5: "hierarchical (differential sequential)",
                0xC6: "hierarchical (differential progressive)",
                0xC7: "hierarchical (differential lossless)",
                0xC9: "arithmetic-coded", 0xCA: "arithmetic-coded progressive",
                0xCB: "arithmetic-coded lossless",
                0xCD: "arithmetic-coded hierarchical",
                0xCE: "arithmetic-coded hierarchical",
                0xCF: "arithmetic-coded hierarchical"}
JPEG_ERRORS = {-1: "invalid Huffman code", -2: "missing or out-of-order "
               "restart marker", -3: "entropy-coded data ends before the "
               "last MCU"}


class JpegScan:
    """A baseline JPEG's frame, tables and scan, as the decoders take it:
    width, height; comps, (n, 5) int32 of h, v, quant table, DC table, AC
    table per component in scan order; qt, (4, 64) uint16 quant tables in
    natural order; hbits (8, 16) and hvals (8, 256) uint8, the Huffman
    tables DC 0-3 then AC 0-3; restart, the restart interval in MCUs (0:
    none); ycc, whether the three components are YCbCr (else RGB); data,
    the bytes after the SOS header."""

    def __init__(self, width, height, comps, qt, hbits, hvals, restart, ycc,
                 data):
        self.width, self.height, self.comps = width, height, comps
        self.qt, self.hbits, self.hvals = qt, hbits, hvals
        self.restart, self.ycc, self.data = restart, ycc, data

    @property
    def shape(self):
        n = len(self.comps)
        return (self.height, self.width) + ((n,) if n > 1 else ())


def _segments(data: bytes, path):
    """(marker, payload, end) of each marker segment from SOI on; for the
    standalone markers the payload is empty. Fill bytes (FF FF ...) before
    a marker are skipped."""
    if not data.startswith(b"\xff\xd8"):
        raise ValueError(f"{path}: not a JPEG file")
    pos = 2
    while True:
        if pos >= len(data) or data[pos] != 0xFF:
            raise ValueError(f"{path}: no JPEG marker at byte {pos}")
        while pos < len(data) and data[pos] == 0xFF:
            pos += 1
        if pos >= len(data):
            raise ValueError(f"{path}: truncated JPEG")
        m = data[pos]
        pos += 1
        if m == 0x01 or 0xD0 <= m <= 0xD8:
            yield m, b"", pos
            continue
        if m == 0xD9:
            raise ValueError(f"{path}: JPEG ends before its scan")
        if pos + 2 > len(data):
            raise ValueError(f"{path}: truncated JPEG")
        (n,) = struct.unpack(">H", data[pos:pos + 2])
        yield m, data[pos + 2:pos + n], pos + n
        pos += n


def _jpeg_frame(m, body, path):
    """(width, height, [(id, h, v, tq)]) of a SOF0 / SOF1 segment; raise
    NotImplementedError on the frames and samples the decoder refuses."""
    if m in JPEG_REFUSED:
        raise NotImplementedError(f"{path}: {JPEG_REFUSED[m]} JPEG is not "
                                  f"supported (baseline and extended "
                                  f"sequential Huffman only)")
    precision, h, w, nf = struct.unpack(">BHHB", body[:6])
    if precision != 8:
        raise NotImplementedError(f"{path}: {precision}-bit JPEG samples are "
                                  f"not supported (8-bit only)")
    comps = [(body[6 + 3 * i], body[7 + 3 * i] >> 4, body[7 + 3 * i] & 15,
              body[8 + 3 * i]) for i in range(nf)]
    if nf == 4:
        raise NotImplementedError(f"{path}: 4-component (CMYK / YCCK) JPEG "
                                  f"is not supported")
    if nf not in (1, 3):
        raise NotImplementedError(f"{path}: {nf}-component JPEG is not "
                                  f"supported")
    if nf == 3 and (comps[0][1] not in (1, 2) or comps[0][2] not in (1, 2)
                    or any(c[1:3] != (1, 1) for c in comps[1:])):
        raise NotImplementedError(
            f"{path}: JPEG sampling factors "
            f"{[f'{c[1]}x{c[2]}' for c in comps]} are not supported (luma "
            f"1x1, 2x1, 1x2 or 2x2 over 1x1 chroma only)")
    if h == 0:
        raise NotImplementedError(f"{path}: JPEG height set by a DNL marker "
                                  f"is not supported")
    return w, h, comps


def _jpeg_size(data: bytes, path):
    for m, body, _ in _segments(data, path):
        if 0xC0 <= m <= 0xCF and m not in (0xC4, 0xC8, 0xCC):
            _, h, w = struct.unpack(">BHH", body[:5])
            return w, h
        if m == 0xDA:
            break
    raise ValueError(f"{path}: JPEG without a frame header")


def parse_jpeg(data: bytes, path="<bytes>") -> JpegScan:
    """The frame, tables and scan of a JPEG (see JpegScan); raise
    NotImplementedError, naming the format, on what the decoder refuses."""
    frame = None
    qt = np.zeros((4, 64), np.uint16)
    hbits = np.zeros((8, 16), np.uint8)
    hvals = np.zeros((8, 256), np.uint8)
    have_q, have_h = set(), set()
    restart, jfif, adobe = 0, False, None
    for m, body, end in _segments(data, path):
        if 0xC0 <= m <= 0xCF and m not in (0xC4, 0xC8, 0xCC):
            frame = _jpeg_frame(m, body, path)
        elif m == 0xCC:
            raise NotImplementedError(f"{path}: arithmetic-coded JPEG is "
                                      f"not supported")
        elif m == 0xC4:
            pos = 0
            while pos < len(body):
                tc, th = body[pos] >> 4, body[pos] & 15
                if tc > 1 or th > 3:
                    raise ValueError(f"{path}: bad Huffman table {tc}/{th}")
                bits = np.frombuffer(body[pos + 1:pos + 17], np.uint8)
                n = int(bits.sum())
                hbits[4 * tc + th] = bits
                hvals[4 * tc + th] = 0
                hvals[4 * tc + th, :n] = np.frombuffer(
                    body[pos + 17:pos + 17 + n], np.uint8)
                have_h.add(4 * tc + th)
                pos += 17 + n
        elif m == 0xDB:
            pos = 0
            while pos < len(body):
                pq, tq = body[pos] >> 4, body[pos] & 15
                if tq > 3:
                    raise ValueError(f"{path}: bad quantisation table {tq}")
                dt = np.dtype(">u2") if pq else np.dtype(np.uint8)
                vals = np.frombuffer(body[pos + 1:pos + 1 + 64 * dt.itemsize],
                                     dt)
                qt[tq, ZIGZAG] = vals
                have_q.add(tq)
                pos += 1 + 64 * dt.itemsize
        elif m == 0xDD:
            (restart,) = struct.unpack(">H", body[:2])
        elif m == 0xE0 and body.startswith(b"JFIF\0"):
            jfif = True
        elif m == 0xEE and body.startswith(b"Adobe") and len(body) >= 12:
            adobe = body[11]
        elif m == 0xDA:
            if frame is None:
                raise ValueError(f"{path}: JPEG scan before its frame")
            w, h, fcomps = frame
            ns = body[0]
            if ns != len(fcomps):
                raise NotImplementedError(
                    f"{path}: a JPEG scan of {ns} of {len(fcomps)} "
                    f"components (non-interleaved, multi-scan) is not "
                    f"supported")
            by_id = {c[0]: c for c in fcomps}
            comps = []
            for i in range(ns):
                cid, tables = body[1 + 2 * i], body[2 + 2 * i]
                _, ch, cv, tq = by_id[cid]
                td, ta = tables >> 4, tables & 15
                if tq not in have_q or td not in have_h or \
                        4 + ta not in have_h:
                    raise ValueError(f"{path}: JPEG component {cid} uses a "
                                     f"table the file does not define")
                comps.append((ch, cv, tq, td, ta))
            ss, se, a = body[1 + 2 * ns:4 + 2 * ns]
            if (ss, se, a) != (0, 63, 0):
                raise ValueError(f"{path}: sequential JPEG scan with "
                                 f"spectral selection {ss}-{se}, {a}")
            ids = tuple(c[0] for c in fcomps)
            ycc = len(fcomps) == 3 and (
                jfif or (adobe != 0 if adobe is not None
                         else ids != (82, 71, 66)))
            return JpegScan(w, h, np.array(comps, np.int32), qt, hbits, hvals,
                            restart, ycc, data[end:])
    raise ValueError(f"{path}: JPEG without a scan")


def read_jpeg(path) -> np.ndarray:
    """Decode a JPEG file as PIL does: see read_jpeg_bytes."""
    return read_jpeg_bytes(_read_file(path), path)


def read_jpeg_bytes(data: bytes, name="<bytes>") -> np.ndarray:
    """Decode a baseline JPEG with the C++ helper: (H, W, 3) uint8 RGB, or
    (H, W) for one component, equal bit for bit to
    np.asarray(PIL.Image.open(f)) (mode RGB or L) and to imageio's read.
    Raises NotImplementedError by name on the formats it refuses (see
    parse_jpeg), RuntimeError when the helper cannot be built, ValueError
    on corrupt data. name is the file named in errors."""
    scan = parse_jpeg(data, name)
    out = np.empty(scan.shape, np.uint8)
    src = np.frombuffer(scan.data, np.uint8)
    err = load_helper("jpeg").ingp_jpeg_decode(
        src.ctypes.data, len(src), scan.width, scan.height, len(scan.comps),
        scan.comps.ctypes.data, scan.qt.ctypes.data, scan.hbits.ctypes.data,
        scan.hvals.ctypes.data, scan.restart, int(scan.ycc), out.ctypes.data)
    if err:
        raise ValueError(f"{name}: corrupt JPEG: {JPEG_ERRORS[err]}")
    return out


def _huffman_lookup(bits, vals):
    """{(length, code): value} of a table's canonical codes."""
    out, code, k = {}, 0, 0
    for length in range(1, 17):
        for _ in range(int(bits[length - 1])):
            out[(length, code)] = int(vals[k])
            code += 1
            k += 1
        code <<= 1
    return out


def _entropy_intervals(data: bytes):
    """The scan's entropy-coded bytes, unstuffed, one bytes object per
    restart interval, and the RSTn marker codes between them; the scan
    ends at its first other marker (or the file's end)."""
    intervals, markers, cur, pos, n = [], [], bytearray(), 0, len(data)
    while pos < n:
        ff = data.find(b"\xff", pos)
        if ff < 0:
            cur += data[pos:]
            break
        cur += data[pos:ff]
        pos = ff + 1
        while pos < n and data[pos] == 0xFF:
            pos += 1
        if pos < n and data[pos] == 0:
            cur.append(0xFF)
            pos += 1
            continue
        if pos < n and 0xD0 <= data[pos] <= 0xD7:
            intervals.append(bytes(cur))
            markers.append(data[pos])
            cur = bytearray()
            pos += 1
            continue
        break
    intervals.append(bytes(cur))
    return intervals, markers


class _Bits:
    """An MSB-first bit reader over bytes; reads past the end give zeros
    and set `ran_out`."""

    def __init__(self, data: bytes):
        self.bits = np.unpackbits(np.frombuffer(data, np.uint8)).tolist()
        self.pos, self.ran_out = 0, False

    def get(self, n: int) -> int:
        v = 0
        for _ in range(n):
            if self.pos < len(self.bits):
                v = 2 * v + self.bits[self.pos]
            else:
                v, self.ran_out = 2 * v, True
            self.pos += 1
        return v

    def symbol(self, table) -> int:
        code = 0
        for length in range(1, 17):
            code = 2 * code + self.get(1)
            if (length, code) in table:
                return table[(length, code)]
        raise ValueError("corrupt JPEG: invalid Huffman code")


def _extend(v: int, s: int) -> int:
    return v - (1 << s) + 1 if v < (1 << (s - 1)) else v


def _idct_1d(i):
    """jidctint.c's 1-D islow butterfly on int64 arrays i[0..7]; its 8
    outputs before the descale."""
    z1 = (i[2] + i[6]) * 4433
    tmp2, tmp3 = z1 + i[6] * -15137, z1 + i[2] * 6270
    tmp0, tmp1 = (i[0] + i[4]) << 13, (i[0] - i[4]) << 13
    t10, t13, t11, t12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = i[7], i[5], i[3], i[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * 9633
    z1, z2 = z1 * -7373, z2 * -20995
    z3, z4 = z3 * -16069 + z5, z4 * -3196 + z5
    t0 = t0 * 2446 + z1 + z3
    t1 = t1 * 16819 + z2 + z4
    t2 = t2 * 25172 + z2 + z3
    t3 = t3 * 12299 + z1 + z4
    return [t10 + t3, t11 + t2, t12 + t1, t13 + t0,
            t13 - t0, t12 - t1, t11 - t2, t10 - t3]


def idct_islow(coef: np.ndarray, q: np.ndarray) -> np.ndarray:
    """libjpeg-turbo's jpeg_idct_islow on (N, 64) coefficients in natural
    order with a (64,) quant table: (N, 8, 8) uint8 samples (columns
    first, descaled by 11 bits, then rows, by 18, plus 128, clamped)."""
    x = (coef.astype(np.int64) * q.astype(np.int64)).reshape(-1, 8, 8)
    cols = _idct_1d([x[:, k, :] for k in range(8)])
    ws = np.stack([(v + (1 << 10)) >> 11 for v in cols], 1)
    rows = _idct_1d([ws[:, :, k] for k in range(8)])
    out = np.stack([(v + (1 << 17)) >> 18 for v in rows], 2) + 128
    return np.clip(out, 0, 255).astype(np.uint8)


def _edge(p, axis, step):
    """p shifted by one sample along axis (step -1: the previous one, +1:
    the next), its edge sample repeated."""
    n = p.shape[axis]
    idx = np.clip(np.arange(n) + step, 0, n - 1)
    return np.take(p, idx, axis)


def upsample_fancy(p: np.ndarray, h: int, v: int) -> np.ndarray:
    """libjpeg-turbo's chroma upsampling (jdsample.c) of a (ch, cw) plane
    by h x v (each 1 or 2), edge samples repeated: h1v2 and, when the
    plane is more than two samples wide, h2v1 and h2v2 by their triangle
    filters; else plain replication."""
    p = p.astype(np.int64)
    fancy_h = h == 2 and p.shape[1] > 2
    if v == 2 and (h == 1 or fancy_h):
        rows = np.empty((2 * p.shape[0], p.shape[1]), np.int64)
        rows[0::2] = 3 * p + _edge(p, 0, -1)
        rows[1::2] = 3 * p + _edge(p, 0, 1)
        if h == 1:
            rows[0::2] = (rows[0::2] + 1) >> 2
            rows[1::2] = (rows[1::2] + 2) >> 2
            return rows.astype(np.uint8)
        out = np.empty((rows.shape[0], 2 * rows.shape[1]), np.int64)
        out[:, 0::2] = (3 * rows + _edge(rows, 1, -1) + 8) >> 4
        out[:, 1::2] = (3 * rows + _edge(rows, 1, 1) + 7) >> 4
        return out.astype(np.uint8)
    if v == 2:
        p = np.repeat(p, 2, 0)
    if h == 2 and fancy_h:
        out = np.empty((p.shape[0], 2 * p.shape[1]), np.int64)
        out[:, 0::2] = (3 * p + _edge(p, 1, -1) + 1) >> 2
        out[:, 1::2] = (3 * p + _edge(p, 1, 1) + 2) >> 2
        return out.astype(np.uint8)
    return np.repeat(p, h, 1).astype(np.uint8)


def ycc_to_rgb(y, cb, cr) -> np.ndarray:
    """jdcolor.c's fixed-point YCbCr -> RGB on uint8 planes: (..., 3)."""
    y, cb, cr = (a.astype(np.int64) - d for a, d in ((y, 0), (cb, 128),
                                                      (cr, 128)))
    r = y + ((91881 * cr + 32768) >> 16)
    g = y + ((-22554 * cb + 32768 - 46802 * cr) >> 16)
    b = y + ((116130 * cb + 32768) >> 16)
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


def decode_jpeg_plain(data: bytes, name="<bytes>") -> np.ndarray:
    """read_jpeg_bytes in numpy and Python, the C++ helper's plain version:
    the Huffman decode bit by bit in Python (seconds for a small image,
    minutes for a large one), then idct_islow, upsample_fancy and
    ycc_to_rgb over whole planes."""
    scan = parse_jpeg(data, name)
    comps, n = scan.comps, len(scan.comps)
    single = n == 1
    hmax, vmax = (1, 1) if single else (int(comps[:, 0].max()),
                                        int(comps[:, 1].max()))
    hs = [1] * n if single else [int(c[0]) for c in comps]
    vs = [1] * n if single else [int(c[1]) for c in comps]
    mcux = -(-scan.width // (8 * hmax))
    mcuy = -(-scan.height // (8 * vmax))
    tables = [_huffman_lookup(scan.hbits[t], scan.hvals[t]) for t in range(8)]
    coef = [np.zeros((mcuy * vs[c], mcux * hs[c], 64), np.int64)
            for c in range(n)]
    intervals, markers = _entropy_intervals(scan.data)
    for i, m in enumerate(markers[:len(intervals) - 1]):
        if m != 0xD0 + (i & 7):
            raise ValueError(f"{name}: corrupt JPEG: {JPEG_ERRORS[-2]}")
    n_mcu = mcux * mcuy
    per = scan.restart or n_mcu
    if len(intervals) < -(-n_mcu // per):
        raise ValueError(f"{name}: corrupt JPEG: {JPEG_ERRORS[-2]}")
    ran_out = False
    for m in range(n_mcu):
        if m % per == 0:
            if m:
                ran_out = ran_out or bits.ran_out
            bits = _Bits(intervals[m // per])
            pred = [0] * n
        my, mx = divmod(m, mcux)
        for c in range(n):
            dc, ac = tables[comps[c, 3]], tables[4 + comps[c, 4]]
            for by in range(vs[c]):
                for bx in range(hs[c]):
                    blk = coef[c][my * vs[c] + by, mx * hs[c] + bx]
                    s = bits.symbol(dc)
                    pred[c] += _extend(bits.get(s), s) if s else 0
                    blk[0] = pred[c]
                    k = 1
                    while k < 64:
                        rs = bits.symbol(ac)
                        r, s = rs >> 4, rs & 15
                        if s:
                            k += r
                            blk[ZIGZAG[min(k, 63)]] = _extend(bits.get(s), s)
                            k += 1
                        elif r == 15:
                            k += 16
                        else:
                            break
    if ran_out or bits.ran_out:
        raise ValueError(f"{name}: corrupt JPEG: {JPEG_ERRORS[-3]}")
    planes = []
    for c in range(n):
        by, bx = coef[c].shape[:2]
        px = idct_islow(coef[c].reshape(-1, 64), scan.qt[comps[c, 2]])
        planes.append(px.reshape(by, bx, 8, 8).transpose(0, 2, 1, 3)
                      .reshape(by * 8, bx * 8))
    h, w = scan.height, scan.width
    if single:
        return planes[0][:h, :w].copy()
    uh, uv = hmax // hs[1], vmax // vs[1]
    cw, ch = -(-w // uh), -(-h // uv)
    cb, cr = (upsample_fancy(p[:ch, :cw], uh, uv)[:h, :w] for p in planes[1:])
    if not scan.ycc:
        return np.stack([planes[0][:h, :w], cb, cr], -1)
    return ycc_to_rgb(planes[0][:h, :w], cb, cr)


# -- reading any of them ----------------------------------------------------

def decode_bytes(data: bytes, name="<bytes>") -> np.ndarray:
    """A PNG, JPEG or binary PGM in memory, told apart by its signature,
    decoded as imageio.v2.imread decodes it (read_png_bytes,
    read_jpeg_bytes, read_pgm_bytes)."""
    if data.startswith(PNG_SIGNATURE):
        return read_png_bytes(data, name)
    if data.startswith(JPEG_SIGNATURE):
        return read_jpeg_bytes(data, name)
    if data.startswith(PGM_SIGNATURE):
        return read_pgm_bytes(data, name)
    raise ValueError(f"{name}: neither PNG, JPEG nor binary PGM (first "
                     f"bytes {data[:8]!r})")


def imread(path) -> np.ndarray:
    """A PNG, JPEG or binary PGM file, by its signature (not its name), as
    imageio.v2.imread returns it."""
    return decode_bytes(_read_file(path), path)


def read_pgm(path) -> np.ndarray:
    """A binary PGM file: see read_pgm_bytes."""
    return read_pgm_bytes(_read_file(path), path)


def read_pgm_bytes(data: bytes, name="<bytes>") -> np.ndarray:
    """A binary PGM (P5) as (H, W): uint8 where maxval < 256, else
    big-endian 16-bit samples as uint16 (imageio gives them as int32,
    equal in value)."""
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
        raise ValueError(f"{name}: not a binary PGM (P5)")
    w, h, maxval = (int(v) for v in fields[1:])
    dtype = np.dtype(np.uint8) if maxval < 256 else np.dtype(">u2")
    pos += 1  # the single whitespace after maxval
    n = w * h * dtype.itemsize
    if len(data) < pos + n:
        raise ValueError(f"{name}: truncated PGM")
    img = np.frombuffer(data[pos:pos + n], dtype).reshape(h, w)
    return img.astype(np.uint8 if maxval < 256 else np.uint16)


def read_u8(path, gray: bool = False) -> np.ndarray:
    """An 8-bit PNG, JPEG or PGM (by its signature) as cv2.imread reads it:
    (H, W, 3) RGB (the channel order of cv2.imread + COLOR_BGR2RGB; gray
    expanded, alpha dropped) or, with gray, (H, W) (cv2.IMREAD_GRAYSCALE).
    16-bit samples keep their high byte, as OpenCV converts them. A
    colour image read as gray raises: cv2 would mix its channels, which no
    loader here asks for."""
    img = imread(path)
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


def read_rgb(path) -> np.ndarray:
    """A PNG or JPEG as PIL's Image.open(path).convert("RGB") gives it:
    (H, W, 3) uint8; gray repeated, alpha dropped, palettes looked up."""
    img = imread(path)
    if img.dtype == np.uint16:
        raise NotImplementedError(f"{path}: 16-bit gray to RGB is not "
                                  f"supported")
    if img.ndim == 2:
        return np.repeat(img[..., None], 3, 2)
    if img.shape[2] == 2:
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


# the standard tables of ITU T.81 Annex K: quantisation (natural order) and
# Huffman (code counts by length, values)
STD_QUANT = (np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99]),
    np.array([17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
              24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99]
             + [99] * 32))
_AC_LUMA_VALS = bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
    "2433627282090a161718191a25262728292a3435363738393a43444546474849"
    "4a535455565758595a636465666768696a737475767778797a83848586878889"
    "8a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5"
    "c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8"
    "f9fa")
_AC_CHROMA_VALS = bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0"
    "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
    "494a535455565758595a636465666768696a737475767778797a828384858687"
    "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
    "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8"
    "f9fa")
STD_HUFFMAN = {  # (class, id): (counts by length 1-16, values)
    (0, 0): (bytes([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0]),
             bytes(range(12))),
    (0, 1): (bytes([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0]),
             bytes(range(12))),
    (1, 0): (bytes([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D]),
             _AC_LUMA_VALS),
    (1, 1): (bytes([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77]),
             _AC_CHROMA_VALS)}
# bit length of |v| for every v a baseline coefficient or DC step takes
_NBITS = np.array([int(v).bit_length() for v in range(4096)], np.int64)


def quality_tables(quality: int):
    """libjpeg's jpeg_set_quality: the Annex K tables scaled by 5000 / q
    below 50, by 200 - 2q from 50, each entry (t * scale + 50) // 100
    clamped to 1-255 (baseline), as uint16 in natural order."""
    q = min(max(int(quality), 1), 100)
    scale = 5000 // q if q < 50 else 200 - 2 * q
    return [np.clip((t * scale + 50) // 100, 1, 255).astype(np.uint16)
            for t in STD_QUANT]


def _code_table(bits, vals):
    """(code, length) arrays over the 256 symbol values of a Huffman
    table's canonical codes."""
    code = np.zeros(256, np.uint64)
    length = np.zeros(256, np.int64)
    for (n, c), v in _huffman_lookup(bits, vals).items():
        code[v], length[v] = c, n
    return code, length


def _dct_matrix() -> np.ndarray:
    """(64, 64): a row-major 8x8 block's orthonormal 2-D DCT-II, the
    JPEG forward DCT, as one matrix (the Kronecker square of the 1-D
    one)."""
    u = np.arange(8)[:, None]
    x = np.arange(8)[None, :]
    m = np.cos((2 * x + 1) * u * np.pi / 16) * np.sqrt(2 / 8)
    m[0] /= np.sqrt(2)
    return np.kron(m, m).astype(np.float32)


def _blocks(plane: np.ndarray) -> np.ndarray:
    """(by, bx, 64) of a plane whose sides are multiples of 8."""
    h, w = plane.shape
    return plane.reshape(h // 8, 8, w // 8, 8).transpose(0, 2, 1, 3) \
        .reshape(h // 8, w // 8, 64)


def _pack_bits(values: np.ndarray, lengths: np.ndarray) -> bytes:
    """values[i] (uint64, lengths[i] <= 64 bits each) written MSB first one
    after another, the last byte padded with 1 bits."""
    starts = np.cumsum(lengths) - lengths
    total = int(lengths.sum())
    word, off = starts >> 6, starts & 63
    end = off + lengths
    inside = end <= 64
    lo = np.left_shift(values, np.clip(64 - end, 0, 63).astype(np.uint64))
    hi = np.right_shift(values, np.clip(end - 64, 0, 63).astype(np.uint64))
    part = np.where(inside, lo, hi)
    words = np.zeros(total // 64 + 2, np.uint64)

    def put(idx, bits):
        if len(idx):
            first = np.flatnonzero(np.r_[True, idx[1:] != idx[:-1]])
            words[idx[first]] |= np.bitwise_or.reduceat(bits, first)
    put(word, part)
    spill = ~inside
    put(word[spill] + 1, np.left_shift(
        values[spill], (128 - end[spill]).astype(np.uint64)))
    out = bytearray(words.astype(">u8").tobytes()[:-(-total // 8)])
    if total % 8:
        out[-1] |= (1 << (8 - total % 8)) - 1
    return bytes(out)


def _stuff(data: bytes) -> bytes:
    """A zero byte after every 0xFF of entropy-coded data."""
    a = np.frombuffer(data, np.uint8)
    return np.insert(a, np.flatnonzero(a == 0xFF) + 1, 0).tobytes()


def _scan_symbols(blocks: np.ndarray, table: np.ndarray, comp: np.ndarray,
                  codes) -> tuple[np.ndarray, np.ndarray]:
    """(values, lengths) of the Huffman symbols and extra bits of the
    quantised zigzag blocks (N, 64) in coding order; table[i] is block i's
    table pair (0 luma, 1 chroma), comp[i] its component for the DC
    prediction. A run of 16+ zeros before a coefficient is folded into its
    symbol as ZRL codes (at most 3 * 11 + 16 + 10 bits)."""
    n = len(blocks)
    dc = blocks[:, 0]
    diff = np.empty(n, np.int64)
    for c in np.unique(comp):
        sel = np.flatnonzero(comp == c)
        diff[sel] = np.diff(dc[sel], prepend=0)

    def extra(v, s):
        return np.where(v >= 0, v, v + (1 << s) - 1).astype(np.uint64)

    s = _NBITS[np.abs(diff)]
    code = np.choose(table, [codes[(0, t)][0][s] for t in (0, 1)])
    clen = np.choose(table, [codes[(0, t)][1][s] for t in (0, 1)])
    keys = [np.arange(n) * 66]
    vals = [(code << s.astype(np.uint64)) | extra(diff, s)]
    lens = [clen + s]

    b, k = np.nonzero(blocks[:, 1:])
    k = k + 1
    v = blocks[b, k]
    first = np.r_[True, b[1:] != b[:-1]]
    prev = np.where(first, 0, np.r_[0, k[:-1]])
    run = k - prev - 1
    z, r = run // 16, run % 16
    s = _NBITS[np.abs(v)]
    t = table[b]
    sym = r * 16 + s
    ac = [codes[(1, i)] for i in (0, 1)]
    code = np.choose(t, [a[0][sym] for a in ac])
    clen = np.choose(t, [a[1][sym] for a in ac])
    zc = np.choose(t, [a[0][0xF0] for a in ac])
    zl = np.choose(t, [a[1][0xF0] for a in ac])
    lead = np.zeros(len(b), np.uint64)
    for i in range(3):
        more = z > i
        lead = np.where(more, (lead << zl.astype(np.uint64)) | zc, lead)
    lead_len = z * zl
    keys.append(b * 66 + k)
    vals.append((((lead << clen.astype(np.uint64)) | code)
                 << s.astype(np.uint64)) | extra(v, s))
    lens.append(lead_len + clen + s)

    last = np.zeros(n, np.int64)
    last[b] = k      # the largest nonzero index of each block (k ascends)
    eob = np.flatnonzero(last < 63)
    te = table[eob]
    keys.append(eob * 66 + 64)
    vals.append(np.choose(te, [a[0][0] for a in ac]))
    lens.append(np.choose(te, [a[1][0] for a in ac]))
    order = np.argsort(np.concatenate(keys), kind="stable")
    return (np.concatenate(vals).astype(np.uint64)[order],
            np.concatenate(lens)[order])


def encode_jpeg(img: np.ndarray, quality: int = 95,
                subsampling: str = "4:2:0") -> bytes:
    """A baseline JPEG of uint8 (H, W) gray or (H, W, 3) RGB: JFIF YCbCr
    (float BT.601 conversion, rounded), chroma averaged over 2x2 pixels
    at 4:2:0 or kept at 4:4:4, edge pixels repeated to whole MCUs, a
    float DCT rounded to the quality's tables (quality_tables), the
    Annex K Huffman tables. Its bytes differ from PIL's; what decodes it
    (PIL, read_jpeg) reads the same pixels."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or not (img.ndim == 2 or (
            img.ndim == 3 and img.shape[2] == 3)):
        raise ValueError(f"encode_jpeg takes uint8 (H, W) or (H, W, 3), not "
                         f"{img.dtype} {img.shape}")
    if subsampling not in ("4:4:4", "4:2:0"):
        raise ValueError(f"subsampling is 4:4:4 or 4:2:0, not {subsampling}")
    h, w = img.shape[:2]
    gray = img.ndim == 2
    f = 2 if subsampling == "4:2:0" and not gray else 1
    ph, pw = -(-h // (8 * f)) * 8 * f, -(-w // (8 * f)) * 8 * f
    x = np.pad(img.reshape(h, w, -1), ((0, ph - h), (0, pw - w), (0, 0)),
               mode="edge").astype(np.float32)
    if gray:
        planes = [x[..., 0]]
    else:
        r, g, b = x[..., 0], x[..., 1], x[..., 2]
        planes = [np.rint(0.299 * r + 0.587 * g + 0.114 * b),
                  np.rint(-0.168736 * r - 0.331264 * g + 0.5 * b + 128),
                  np.rint(0.5 * r - 0.418688 * g - 0.081312 * b + 128)]
        if f == 2:
            planes[1:] = [np.floor(p.reshape(ph // 2, 2, pw // 2, 2)
                                   .sum((1, 3)) * 0.25 + 0.5)
                          for p in planes[1:]]
    qts = quality_tables(quality)
    m = _dct_matrix()
    coded = []
    for i, p in enumerate(planes):
        blk = _blocks(np.clip(p, 0, 255) - 128).reshape(-1, 64)
        q = np.rint((blk @ m.T) / qts[min(i, 1)]).astype(np.int64)
        q[:, 1:] = np.clip(q[:, 1:], -1023, 1023)
        by, bx = p.shape[0] // 8, p.shape[1] // 8
        coded.append(q[:, ZIGZAG].reshape(by, bx, 64))
    # coding order: per MCU the f x f luma blocks, then Cb, then Cr
    my, mx = ph // (8 * f), pw // (8 * f)
    mcu = [coded[0].reshape(my, f, mx, f, 64).transpose(0, 2, 1, 3, 4)
           .reshape(my * mx, f * f, 64)]
    mcu += [c.reshape(my * mx, 1, 64) for c in coded[1:]]
    blocks = np.concatenate(mcu, 1)
    per = blocks.shape[1]
    comp = np.tile(np.r_[np.zeros(f * f, np.int64), np.arange(1, per - f * f
                                                              + 1)], my * mx)
    table = (comp > 0).astype(np.int64)
    codes = {(c, t): _code_table(*STD_HUFFMAN[(c, t)])
             for c in (0, 1) for t in (0, 1)}
    vals, lens = _scan_symbols(blocks.reshape(-1, 64), table, comp, codes)
    scan = _stuff(_pack_bits(vals, lens))

    def seg(marker, body):
        return bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body
    nq = 1 if gray else 2
    out = [b"\xff\xd8", seg(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01"
                                  b"\x00\x00"),
           seg(0xDB, b"".join(bytes([t]) + qts[t][ZIGZAG].astype(np.uint8)
                              .tobytes() for t in range(nq)))]
    ncomp = 1 if gray else 3
    sof = struct.pack(">BHHB", 8, h, w, ncomp) + bytes([1, f * 16 + f, 0])
    if not gray:
        sof += bytes([2, 0x11, 1, 3, 0x11, 1])
    out.append(seg(0xC0, sof))
    out.append(seg(0xC4, b"".join(
        bytes([c * 16 + t]) + STD_HUFFMAN[(c, t)][0] + STD_HUFFMAN[(c, t)][1]
        for c in (0, 1) for t in range(nq))))
    sos = bytes([ncomp]) + b"".join(bytes([i + 1, 0x11 * min(i, 1)])
                                    for i in range(ncomp)) + b"\x00\x3f\x00"
    out += [seg(0xDA, sos), scan, b"\xff\xd9"]
    return b"".join(out)


def write_jpeg(path, img: np.ndarray, quality: int = 95,
               subsampling: str = "4:2:0") -> None:
    """Write encode_jpeg(img, quality, subsampling) to path."""
    data = encode_jpeg(img, quality, subsampling)
    with open(path, "wb") as f:
        f.write(data)


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


# Pillow's Resample.c: 8-bit coefficients carry PRECISION_BITS fraction bits
LANCZOS_PRECISION_BITS = 32 - 8 - 2
LANCZOS_SUPPORT = 3.0
LANCZOS_BLOCK = 32
LANCZOS_THREADS = 8


def _sinc(x: float) -> float:
    if x == 0.0:
        return 1.0
    x = x * math.pi
    return math.sin(x) / x


def _lanczos(x: float) -> float:
    return _sinc(x) * _sinc(x / 3) if -3.0 <= x < 3.0 else 0.0


@functools.lru_cache(maxsize=32)
def lanczos_coeffs(src: int, dst: int):
    """Pillow's precompute_coeffs and normalize_coeffs_8bpc for LANCZOS
    along one axis: (first tap (dst,), tap count (dst,), fixed-point
    weights (dst, ksize) int64). The support is 3 x the scale (at least
    3); output d centres at (d + 0.5) * scale; its taps run from
    int(centre - support + 0.5) (at least 0) to int(centre + support +
    0.5) (at most src); each weight, lanczos((x - centre + 0.5) / scale)
    in double through libm's sin, is divided by their sum and rounded
    half away from zero to 22 fraction bits. The weights are summed one
    after another as Pillow does (Python's sum() compensates)."""
    scale = src / dst
    filterscale = max(scale, 1.0)
    support = LANCZOS_SUPPORT * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    ss = 1.0 / filterscale
    first = np.zeros(dst, np.int64)
    count = np.zeros(dst, np.int64)
    kk = np.zeros((dst, ksize), np.int64)
    one = float(1 << LANCZOS_PRECISION_BITS)
    for d in range(dst):
        center = (d + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), src) - xmin
        w = [_lanczos((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        total = 0.0
        for v in w:
            total += v
        if total != 0.0:
            w = [v / total for v in w]
        kk[d, :xmax] = [int(-0.5 + v * one) if v < 0 else int(0.5 + v * one)
                        for v in w]
        first[d], count[d] = xmin, xmax
    return first, count, kk


def _lanczos_pass(x: np.ndarray, first, count, kk, axis: int) -> np.ndarray:
    """One pass of Pillow's 8-bit resample along axis 0 or 1 of uint8
    (H, W, C): per output pixel the sum of its taps' samples times their
    weights from a half-unit bias, in int64, shifted right by 22 bits
    and clipped to 0-255. Blocks of LANCZOS_BLOCK rows (axis 1) or output
    rows (axis 0) keep the temporaries in cache; the blocks run on up to
    LANCZOS_THREADS threads (numpy releases the GIL in its loops)."""
    last = x.shape[axis] - 1
    taps = [(np.minimum(first + k, last), np.where(count > k, kk[:, k], 0))
            for k in range(kk.shape[1]) if (count > k).any()]
    shape = list(x.shape)
    shape[axis] = len(first)
    out = np.empty(shape, np.uint8)
    n = x.shape[0] if axis == 1 else len(first)

    def block(r0):
        r1 = min(r0 + LANCZOS_BLOCK, n)
        acc = np.full((r1 - r0,) + tuple(shape[1:]),
                      1 << (LANCZOS_PRECISION_BITS - 1), np.int64)
        for idx, wk in taps:
            if axis == 1:
                acc += x[r0:r1, idx] * wk[None, :, None]
            else:
                acc += x[idx[r0:r1]] * wk[r0:r1, None, None]
        out[r0:r1] = np.clip(acc >> LANCZOS_PRECISION_BITS, 0, 255)
    starts = range(0, n, LANCZOS_BLOCK)
    workers = min(LANCZOS_THREADS, os.cpu_count() or 1, len(starts))
    if workers > 1:
        with ThreadPoolExecutor(workers) as pool:
            list(pool.map(block, starts))
    else:
        for r0 in starts:
            block(r0)
    return out


def resize_lanczos(img: np.ndarray, wh) -> np.ndarray:
    """PIL's Image.resize((w, h), Image.LANCZOS) of uint8 (H, W) gray or
    (H, W, 3) RGB, bit for bit (Pillow's ImagingResampleInner): the
    horizontal pass over only the rows the vertical pass reads, then the
    vertical pass, each with lanczos_coeffs' fixed-point weights; an axis
    whose size does not change is not resampled."""
    if img.dtype != np.uint8 or img.ndim not in (2, 3):
        raise ValueError(f"resize_lanczos takes uint8 (H, W) or (H, W, C), "
                         f"not {img.dtype} {img.shape}")
    w, h = (int(v) for v in wh)
    H, W = img.shape[:2]
    x = img.reshape(H, W, -1)
    if h != H:
        vfirst, vcount, vk = lanczos_coeffs(H, h)
        y0, y1 = int(vfirst[0]), int(vfirst[-1] + vcount[-1])
    else:
        y0, y1 = 0, H
    if w != W:
        x = _lanczos_pass(x[y0:y1], *lanczos_coeffs(W, w), axis=1)
    if h != H:
        x = _lanczos_pass(x if w != W else x[y0:y1], vfirst - y0, vcount, vk,
                          axis=0)
    return x.reshape((h, w) + img.shape[2:])
