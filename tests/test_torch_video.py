"""The port's Motion-JPEG AVI video IO (ingp_tpu_torch/utility/video.py)
against OpenCV, which the JAX package's video tools call: JAX's
`extract_frames` and the port's on an AVI that the port wrote give the
same PNG pixels, the port reads AVIs that cv2 wrote (through its ffmpeg
and its own MJPEG backends) to cv2's frames, a round trip keeps smooth
frames above 35 dB, and what the port does not write or read raises.

cv2 decodes an MJPEG AVI two ways. Its own backend (CAP_OPENCV_MJPEG)
decodes each frame with libjpeg, as the port's decoder does: the pixels
are equal. Its ffmpeg backend, the default that `cv2.VideoCapture(path)`
takes, decodes with libavcodec's IDCT and converts YUV to BGR with
swscale: those pixels differ from libjpeg's by up to 13 levels on these
frames (measured 12-13), so they are held to 35 dB."""
import os

import numpy as np
import pytest

from ingp_tpu_torch.data import image_io
from ingp_tpu_torch.utility import video as tv
from tests._torch_threads import one_torch_thread  # noqa: F401

cv2 = pytest.importorskip("cv2")

FFMPEG_LEVELS = 16      # ffmpeg's decode against libjpeg's, at most


def _frames(n=4, h=48, w=64):
    y, x = np.mgrid[0:h, 0:w]
    return [np.stack([127 + 100 * np.sin(x / 9 + i),
                      127 + 100 * np.cos(y / 7 - i),
                      127 + 60 * np.sin((x + y) / 11)], -1).astype(np.uint8)
            for i in range(n)]


def _psnr(a, b):
    return 10 * np.log10(255.0 ** 2 / np.mean((a.astype(float) - b) ** 2))


def _cv2_frames(path, api):
    cap = cv2.VideoCapture(str(path), api)
    assert cap.isOpened()
    out = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        out.append(f[..., ::-1])
    cap.release()
    return out


def _pngs(d):
    return [image_io.read_png(os.path.join(d, f))
            for f in sorted(os.listdir(d))]


@pytest.mark.parametrize("backend", ["mjpeg", "ffmpeg"])
def test_jax_extract_frames_on_port_avi(tmp_path, backend, monkeypatch):
    from ingp_tpu.utility import video as jv
    src = tmp_path / "in"
    src.mkdir()
    frames = _frames()
    for i, f in enumerate(frames):
        image_io.write_png(src / f"{i:03d}.png", f)
    assert tv.assemble_video(str(src), str(tmp_path / "v.avi"), fps=24) == 4
    if backend == "mjpeg":
        capture = cv2.VideoCapture
        monkeypatch.setattr(jv.cv2, "VideoCapture",
                            lambda p: capture(p, cv2.CAP_OPENCV_MJPEG))
    assert jv.extract_frames(str(tmp_path / "v.avi"),
                             str(tmp_path / "jax")) == 4
    assert tv.extract_frames(str(tmp_path / "v.avi"),
                             str(tmp_path / "port")) == 4
    want, got = _pngs(tmp_path / "jax"), _pngs(tmp_path / "port")
    for w, g, f in zip(want, got, frames):
        assert g.shape == w.shape == f.shape
        if backend == "mjpeg":
            np.testing.assert_array_equal(g, w)
        else:
            assert np.abs(g.astype(int) - w).max() <= FFMPEG_LEVELS
            assert _psnr(g, w) > 35
        assert _psnr(g, f) > 35          # the round trip
    # every other frame
    assert tv.extract_frames(str(tmp_path / "v.avi"), str(tmp_path / "e2"),
                             every=2) == 2
    np.testing.assert_array_equal(_pngs(tmp_path / "e2")[1], got[2])


@pytest.mark.parametrize("writer", ["CAP_FFMPEG", "CAP_OPENCV_MJPEG"])
def test_port_reads_cv2_avi(tmp_path, writer):
    frames = _frames(3)
    path = str(tmp_path / "cv.avi")
    w = cv2.VideoWriter(path, getattr(cv2, writer),
                        cv2.VideoWriter_fourcc(*"MJPG"), 30, (64, 48))
    assert w.isOpened()
    for f in frames:
        w.write(np.ascontiguousarray(f[..., ::-1]))
    w.release()
    got = tv.read_avi(path)
    want = _cv2_frames(path, cv2.CAP_OPENCV_MJPEG)
    assert len(got) == len(want) == 3
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g, w_)
    for g, w_ in zip(got, _cv2_frames(path, cv2.CAP_FFMPEG)):
        assert np.abs(g.astype(int) - w_).max() <= FFMPEG_LEVELS
    for g, f in zip(got, frames):
        assert _psnr(g, f) > 35


def test_port_avi_round_trip_and_refusals(tmp_path):
    frames = _frames(5, 37, 53)
    assert tv.write_avi(tmp_path / "r.avi", frames, fps=29.97) == 5
    got = tv.read_avi(tmp_path / "r.avi")
    assert [g.shape for g in got] == [(37, 53, 3)] * 5
    assert min(_psnr(g, f) for g, f in zip(got, frames)) > 35
    cap = cv2.VideoCapture(str(tmp_path / "r.avi"), cv2.CAP_OPENCV_MJPEG)
    assert cap.get(cv2.CAP_PROP_FRAME_COUNT) == 5
    assert cap.get(cv2.CAP_PROP_FPS) == pytest.approx(29.97, rel=1e-6)
    with pytest.raises(ValueError, match="Motion-JPEG AVI"):
        tv.assemble_video(str(tmp_path), str(tmp_path / "out.mp4"))
    (tmp_path / "x.mp4").write_bytes(b"\0\0\0\x18ftypmp42" + bytes(16))
    with pytest.raises(ValueError, match="not an AVI"):
        tv.extract_frames(str(tmp_path / "x.mp4"), str(tmp_path / "o"))
    w = cv2.VideoWriter(str(tmp_path / "x.avi"), cv2.CAP_FFMPEG,
                        cv2.VideoWriter_fourcc(*"XVID"), 30, (64, 48))
    if w.isOpened():
        for f in _frames(2):
            w.write(f)
        w.release()
        with pytest.raises(ValueError, match="codec"):
            tv.read_avi(tmp_path / "x.avi")
    assert tv.assemble_video(str(tmp_path / "empty"),
                             str(tmp_path / "e.avi")) == 0


@pytest.mark.parametrize("kind", ["gray", "rgba", "rgb16"])
def test_assemble_reads_frames_as_cv2(tmp_path, kind):
    """assemble_video takes each frame as cv2.imread's colour mode does
    (JAX's reader): gray repeated, alpha dropped, 16-bit scaled by 1/256
    with cv2's rounding (half to even)."""
    rng = np.random.default_rng(7)
    if kind == "rgb16":
        img = rng.integers(0, 65536, (12, 10, 3), dtype=np.uint16)
        img[0, :3] = [[128, 384, 65535], [127, 129, 640], [0, 1, 65408]]
        cv2.imwrite(str(tmp_path / "f.png"), img[..., ::-1])
    else:
        img = rng.integers(0, 256, (12, 10) if kind == "gray" else
                           (12, 10, 4), dtype=np.uint8)
        image_io.write_png(tmp_path / "f.png", img)
    want = cv2.imread(str(tmp_path / "f.png"))[..., ::-1]
    np.testing.assert_array_equal(tv._rgb(image_io.imread(tmp_path / "f.png")),
                                  want)
    assert tv.assemble_video(str(tmp_path), str(tmp_path / "v.avi")) == 1
    np.testing.assert_array_equal(
        tv.read_avi(tmp_path / "v.avi")[0],
        image_io.read_jpeg_bytes(image_io.encode_jpeg(want, tv.QUALITY,
                                                      "4:2:0")))
