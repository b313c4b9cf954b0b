"""The port's line segment detector and up-vector estimate
(ingp_tpu_torch/utility/vanishing_point.py, csrc/lsd.cpp) against OpenCV's
`createLineSegmentDetector()` and the JAX package's `estimate_up_vector`,
on seeded synthetic images: a facade of rectangles in perspective (its
verticals meet at a known point above the image), random segments, and
random segments under noise. The segments must be cv2's, in cv2's order
(the RANSAC picks them by index), endpoints within 1e-3 px (measured:
equal), and at sizes whose 0.8 resize rounds each way; the grey
conversion is held to cv2's RGB2GRAY bit for bit."""
import numpy as np
import pytest

from tests._torch_threads import one_torch_thread  # noqa: F401

cv2 = pytest.importorskip("cv2")

from ingp_tpu_torch.utility import vanishing_point as tvp  # noqa: E402


def facade(seed, h=240, w=320, vp=None):
    """Dark quads on a light wall, their sides meeting at vp (a point
    above the image) as a building's verticals do in perspective."""
    rng = np.random.default_rng(seed)
    img = np.full((h, w, 3), 200, np.uint8)
    vx, vy = vp if vp is not None else (w * 0.5 + rng.uniform(-40, 40),
                                        -600.0)
    for _ in range(14):
        x0, y0 = rng.uniform(10, w - 60), rng.uniform(h * 0.4, h - 5)
        top = rng.uniform(5, y0 - 30)
        wd = rng.uniform(15, 50)
        pts = []
        for x in (x0, x0 + wd):
            t = (y0 - top) / (y0 - vy)
            pts.append(((x, y0), (x + (vx - x) * t, top)))
        poly = np.array([pts[0][0], pts[1][0], pts[1][1], pts[0][1]])
        cv2.fillPoly(img, [np.round(poly).astype(np.int32)],
                     tuple(int(c) for c in rng.integers(0, 120, 3)))
    return img


def random_segments(seed, h=200, w=260, noise=0.0):
    rng = np.random.default_rng(seed)
    img = np.full((h, w, 3), 30, np.uint8)
    for _ in range(25):
        p = rng.uniform(0, [w, h], (2, 2)).astype(int)
        cv2.line(img, tuple(map(int, p[0])), tuple(map(int, p[1])),
                 tuple(int(c) for c in rng.integers(100, 255, 3)),
                 int(rng.integers(1, 4)))
    if noise:
        img = np.clip(img + rng.normal(0, noise, img.shape), 0,
                      255).astype(np.uint8)
    return img


IMAGES = {"facade": lambda s: facade(s),
          "segments": lambda s: random_segments(s),
          "noisy": lambda s: random_segments(s, noise=12.0)}


@pytest.mark.parametrize("kind", sorted(IMAGES))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lsd_matches_cv2(kind, seed):
    img = IMAGES[kind](seed)
    gray = cv2.cvtColor(img, cv2.COLOR_RGB2GRAY)
    np.testing.assert_array_equal(tvp.rgb_to_gray(img), gray)
    want = cv2.createLineSegmentDetector().detect(gray)[0].reshape(-1, 4)
    got = tvp.detect_line_segments(gray)
    assert got.dtype == np.float32 and len(got) == len(want) > 20
    assert np.abs(got - want).max() <= 1e-3


def test_rgb_to_gray_matches_cv2():
    rng = np.random.default_rng(5)
    rgb = rng.integers(0, 256, (4096, 3), dtype=np.uint8)[None]
    np.testing.assert_array_equal(tvp.rgb_to_gray(rgb),
                                  cv2.cvtColor(rgb, cv2.COLOR_RGB2GRAY))


@pytest.mark.parametrize("h,w", [(60, 80), (61, 81), (37, 100), (23, 17)])
def test_lsd_matches_cv2_at_odd_sizes(h, w):
    """Sizes whose 0.8 resize rounds each way (and one of a few pixels a
    side), on blurred noise with a few lines: the detector's blur,
    resize and angles show through its segments."""
    rng = np.random.default_rng(h * w)
    img = (rng.random((h, w)) * 255).astype(np.uint8)
    for _ in range(4):
        p = rng.uniform(0, [w, h], (2, 2)).astype(int)
        cv2.line(img, tuple(map(int, p[0])), tuple(map(int, p[1])),
                 int(rng.integers(0, 256)), int(rng.integers(1, 3)))
    img = cv2.GaussianBlur(img, (3, 3), 1)
    want = cv2.createLineSegmentDetector().detect(img)[0]
    want = np.zeros((0, 4), np.float32) if want is None else \
        want.reshape(-1, 4)
    got = tvp.detect_line_segments(img)
    assert got.shape == want.shape
    assert not len(got) or np.abs(got - want).max() <= 1e-3


@pytest.mark.parametrize("kind", sorted(IMAGES))
def test_up_vector_matches_jax(kind):
    from ingp_tpu.utility import vanishing_point as jvp
    K = np.array([[300.0, 0, 160], [0, 300.0, 120], [0, 0, 1]])
    for seed in (0, 1):
        img = IMAGES[kind](seed)
        want = jvp.estimate_up_vector(img, K)
        got = tvp.estimate_up_vector(img, K, device="cpu")
        if want is None:
            assert got is None
            continue
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, atol=1e-5)
        vj, cj = jvp.estimate_vertical_vp(img)
        vt, ct = tvp.estimate_vertical_vp(img, device="cpu")
        assert ct == cj


def test_up_vector_finds_known_vanishing_point():
    """The facade's verticals meet at (170, -600): the up vector is the
    ray through it, within a degree."""
    K = np.array([[300.0, 0, 160], [0, 300.0, 120], [0, 0, 1]])
    up = tvp.estimate_up_vector(facade(3, vp=(170.0, -600.0)), K,
                                device="cpu")
    ray = np.linalg.inv(K) @ np.array([170.0, -600.0, 1.0])
    ray = -ray / np.linalg.norm(ray) if ray[1] > 0 else \
        ray / np.linalg.norm(ray)
    assert np.degrees(np.arccos(np.clip(up @ ray, -1, 1))) < 1.0
