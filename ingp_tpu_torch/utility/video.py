"""Video frame extraction and assembly (counterpart of
ingp_tpu/utility/video.py) without OpenCV or ffmpeg.

The JAX package writes `mp4v` through cv2.VideoWriter. The port has
neither cv2 nor an MPEG-4 encoder, so it writes Motion-JPEG in an AVI
(RIFF) container, what cv2 writes for the `MJPG` fourcc: each frame a
baseline JPEG from the port's encoder (`data/image_io.encode_jpeg`,
4:2:0, quality 95 as cv2's writer), one `00dc` chunk each, with an
`idx1` index. The reader walks the RIFF tree (skipping `JUNK`, `LIST
odml`, `LIST INFO` and index chunks), decodes each `00dc` chunk with the
port's JPEG decoder (libjpeg's pixels, as cv2's own MJPEG backend gives
them) and writes PNGs with `write_png`. Any other container or codec
raises a ValueError that names the cause.
"""
from __future__ import annotations

import glob
import os
import struct
from fractions import Fraction

import numpy as np

from ..data import image_io

QUALITY = 95
AVIF_HASINDEX = 0x10
AVIIF_KEYFRAME = 0x10


def _chunk(fourcc: bytes, payload: bytes) -> bytes:
    return fourcc + struct.pack("<I", len(payload)) + payload \
        + b"\0" * (len(payload) & 1)


def _list(kind: bytes, payload: bytes) -> bytes:
    return _chunk(b"LIST", kind + payload)


def write_avi(path, frames, fps=30) -> int:
    """Write uint8 (H, W, 3) RGB frames (an iterable, all one size) as a
    Motion-JPEG AVI. Returns the frame count."""
    jpegs, size = [], None
    for f in frames:
        f = np.asarray(f)
        if size is None:
            size = f.shape[:2]
        elif f.shape[:2] != size:
            raise ValueError(f"write_avi: frame {len(jpegs)} is "
                             f"{f.shape[:2]}, the first {size}")
        jpegs.append(image_io.encode_jpeg(f, QUALITY, "4:2:0"))
    if not jpegs:
        raise ValueError("write_avi: no frames")
    h, w = size
    rate = Fraction(fps).limit_denominator(1001000)
    biggest = max(len(j) for j in jpegs)
    avih = struct.pack("<10I4I", round(1e6 / float(rate)), 0, 0,
                       AVIF_HASINDEX, len(jpegs), 0, 1, biggest, w, h,
                       0, 0, 0, 0)
    strh = struct.pack("<4s4sIHHIIIIIIIIhhhh", b"vids", b"MJPG", 0, 0, 0, 0,
                       rate.denominator, rate.numerator, 0, len(jpegs),
                       biggest, 0xFFFFFFFF, 0, 0, 0, w, h)
    strf = struct.pack("<IiiHH4sIiiII", 40, w, h, 1, 24, b"MJPG",
                       w * h * 3, 0, 0, 0, 0)
    hdrl = _list(b"hdrl", _chunk(b"avih", avih) + _list(
        b"strl", _chunk(b"strh", strh) + _chunk(b"strf", strf)))
    movi, index, pos = [], [], 4          # offsets from the 'movi' fourcc
    for j in jpegs:
        index.append(struct.pack("<4sIII", b"00dc", AVIIF_KEYFRAME, pos,
                                 len(j)))
        movi.append(_chunk(b"00dc", j))
        pos += len(movi[-1])
    body = b"AVI " + hdrl + _list(b"movi", b"".join(movi)) \
        + _chunk(b"idx1", b"".join(index))
    with open(path, "wb") as fh:
        fh.write(_chunk(b"RIFF", body))
    return len(jpegs)


def _walk(data: bytes, start: int, end: int, path):
    """(fourcc, payload start, payload size) of each chunk in [start, end),
    descending into LIST hdrl / strl / movi / rec and past other lists."""
    pos = start
    while pos + 8 <= end:
        fourcc, size = data[pos:pos + 4], struct.unpack_from(
            "<I", data, pos + 4)[0]
        body = pos + 8
        if body + size > end:
            raise ValueError(f"{path}: chunk {fourcc!r} at {pos} runs past "
                             "the end of the file")
        if fourcc in (b"LIST", b"RIFF"):
            kind = data[body:body + 4]
            if kind in (b"hdrl", b"strl", b"movi", b"rec ", b"AVIX",
                        b"AVI "):
                yield from _walk(data, body + 4, body + size, path)
            # other lists (odml, INFO) hold nothing the reader needs
        else:
            yield fourcc, body, size
        pos = body + size + (size & 1)


def read_avi(path):
    """The frames of a Motion-JPEG AVI: a list of (H, W, 3) uint8 RGB.
    Raises ValueError for anything else."""
    with open(path, "rb") as fh:
        data = fh.read()
    if data[:4] != b"RIFF" or data[8:12] != b"AVI ":
        raise ValueError(f"{path}: not an AVI (RIFF ... AVI) file; the port "
                         "reads Motion-JPEG AVI only")
    frames, codec = [], None
    riff_end = 8 + struct.unpack_from("<I", data, 4)[0]
    for fourcc, at, size in _walk(data, 0, min(len(data), riff_end), path):
        if fourcc == b"strf" and codec is None:
            codec = data[at + 16:at + 20]
            if codec.upper() != b"MJPG":
                raise ValueError(f"{path}: video codec {codec!r}; the port "
                                 "reads Motion-JPEG (MJPG) AVI only")
        elif fourcc[2:] == b"dc" and size:
            frames.append(image_io.read_jpeg_bytes(data[at:at + size],
                                                   str(path)))
        elif fourcc[2:] == b"db":
            raise ValueError(f"{path}: uncompressed frames; the port reads "
                             "Motion-JPEG (MJPG) AVI only")
    if codec is None:
        raise ValueError(f"{path}: no video stream format (strf)")
    return [f if f.ndim == 3 else np.repeat(f[..., None], 3, 2)
            for f in frames]


def extract_frames(video_path, out_dir, every=1, ext="png"):
    """Dump every `every`-th frame of a Motion-JPEG AVI to
    out_dir/%06d.<ext> (png, or jpg at quality 95). Returns the count."""
    write = {"png": image_io.write_png,
             "jpg": lambda p, f: image_io.write_jpeg(p, f, QUALITY),
             "jpeg": lambda p, f: image_io.write_jpeg(p, f, QUALITY)}
    if ext not in write:
        raise ValueError(f"extract_frames writes png or jpg, not {ext}")
    frames = read_avi(video_path)
    os.makedirs(out_dir, exist_ok=True)
    saved = 0
    for i in range(0, len(frames), every):
        write[ext](os.path.join(out_dir, f"{saved:06d}.{ext}"), frames[i])
        saved += 1
    return saved


def _rgb(img):
    """An image as 3-channel RGB uint8, as cv2.imread's colour mode reads
    it: 16-bit samples scaled by 1/256 and rounded, gray repeated, alpha
    dropped."""
    if img.dtype != np.uint8:
        img = np.rint(img / 256.0).clip(0, 255).astype(np.uint8)
    if img.ndim == 2:
        return np.repeat(img[..., None], 3, 2)
    return img[..., :3]


def assemble_video(frame_dir, out_path, fps=30, pattern="*.png"):
    """Stitch sorted frames into a Motion-JPEG AVI (out_path must end in
    .avi). Returns the frame count."""
    if os.path.splitext(str(out_path))[1].lower() != ".avi":
        raise ValueError(f"{out_path}: the port writes Motion-JPEG AVI "
                         "only (the JAX package's mp4v needs OpenCV's "
                         "MPEG-4 encoder); name the output .avi")
    frames = sorted(glob.glob(os.path.join(frame_dir, pattern)))
    if not frames:
        return 0
    return write_avi(out_path, (_rgb(image_io.imread(f)) for f in frames),
                     fps)
