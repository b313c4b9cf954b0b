"""The port's plane fit, Poisson blend and ocean-wave tools
(ingp_tpu_torch/utility/) against the JAX package's on the CPU: RANSAC's
inlier mask equal and its plane's center within 1e-9 (the normal equal
up to sign), the least-squares plane likewise, the blend within 1e-9 of
the JAX package's scipy `spsolve` (a region inside the target and one
that touches its border), the spectrum within rtol 1e-5, the seeded
field from the same key, the displacement fields within 1e-4 of their
largest value, and the GIF's frame count and size."""
import numpy as np
import jax
import pytest
import torch

from ingp_tpu.utility import fit_plane as jfp
from ingp_tpu.utility import ocean_wave as jow
from ingp_tpu.utility import poisson_blend as jpb
from ingp_tpu_torch.core import prng
from ingp_tpu_torch.utility import fit_plane as tfp
from ingp_tpu_torch.utility import ocean_wave as tow
from ingp_tpu_torch.utility import poisson_blend as tpb
from tests._torch_threads import one_torch_thread  # noqa: F401


def _plane_points(seed, n=4000, outliers=0.3):
    rng = np.random.default_rng(seed)
    uv = rng.uniform(-1, 1, (n, 2))
    normal = np.array([0.3, -0.2, 0.93])
    normal /= np.linalg.norm(normal)
    a = np.cross(normal, [1.0, 0, 0])
    a /= np.linalg.norm(a)
    b = np.cross(normal, a)
    pts = uv[:, :1] * a + uv[:, 1:] * b + 0.4 * normal \
        + rng.normal(0, 0.003, (n, 1)) * normal
    k = int(n * outliers)
    pts[:k] = rng.uniform(-1, 1, (k, 3))
    return pts


def _same_plane(n0, c0, n1, c1):
    assert abs(abs(float(n0 @ n1)) - 1.0) < 1e-12
    np.testing.assert_allclose(c0, c1, atol=1e-9)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plane_ransac_matches_jax(seed):
    pts = _plane_points(seed)
    # seed 2: 3 points on a line among the first, so degenerate triples
    # are drawn and skipped (they still consume draws)
    if seed == 2:
        pts[:40] = np.outer(np.linspace(0, 1, 40), [1.0, 2.0, 3.0])
        pts = pts[:60]
    want_plane, want_mask = jfp.plane_ransac(pts, n_iters=150,
                                             threshold=0.01, seed=seed)
    got_plane, got_mask = tfp.plane_ransac(pts, n_iters=150,
                                           threshold=0.01, seed=seed,
                                           device="cpu")
    np.testing.assert_array_equal(got_mask, want_mask)
    _same_plane(got_plane.normal, got_plane.center, want_plane.normal,
                want_plane.center)
    assert got_plane.mean_absolute_error(pts[got_mask]) == pytest.approx(
        want_plane.mean_absolute_error(pts[want_mask]), rel=1e-9)


def test_plane_lse_matches_jax():
    pts = _plane_points(3, outliers=0.0)
    nj, dj = jfp.plane_lse(pts)
    nt, dt = tfp.plane_lse(pts, device="cpu")
    pj, pt = jfp.Plane((*nj, dj)), tfp.Plane((*nt, dt))
    _same_plane(pt.normal, pt.center, pj.normal, pj.center)
    # normal and d flip together
    assert float(nt @ nj) * dt == pytest.approx(dj, abs=1e-12)


@pytest.mark.parametrize("case", ["inside", "border", "unit"])
def test_poisson_blending_matches_spsolve(case):
    rng = np.random.default_rng(4)
    src = rng.uniform(0, 255, (40, 50, 3))
    tar = rng.uniform(0, 255, (36, 44, 3))
    mask, pos = (5, 25, 7, 37), (6, 9)
    if case == "border":
        mask, pos = (2, 32, 3, 28), (0, 0)
    if case == "unit":
        src, tar = src / 255.0, tar / 255.0
        mask, pos = (0, 17, 0, 23), (36 - 17, 44 - 23)
    want = jpb.poisson_blending(src, mask, tar, pos)
    got = tpb.poisson_blending(src, mask, tar, pos, device="cpu")
    assert got.dtype == np.float64 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
    assert not np.array_equal(got, tar)


def _spectrum_close(got, want):
    """rtol 2e-5 plus 1e-5 of the largest value. The lattice is
    jnp.linspace's bit for bit (below), but XLA's fused evaluation rounds
    a third of the wavevectors otherwise in the last bit, and the
    spectrum's powers of k carry that: measured 1.23e-5 relative at most
    on the largest values; near its zeros (the low-k cutoff, the
    crosswind directions) the relative gap grows, under 7e-6 of the
    largest value in absolute terms."""
    np.testing.assert_allclose(got, want, rtol=2e-5,
                               atol=1e-5 * np.abs(want).max())


def test_wave_vectors_and_spectrum_match_jax():
    import jax.numpy as jnp
    for res in (1, 2, 31, 63, 64, 512, 1000):
        np.testing.assert_array_equal(
            tow._lattice(res).numpy(),
            np.asarray(jnp.linspace(0.5, res + 0.5, res)))
    for res, size in ((64, 15.0), (63, 250.0)):
        Kj, kj = (np.asarray(a) for a in jow.wave_vectors(res, size))
        Kt, kt = tow.wave_vectors(res, size, device="cpu")
        # the wrap decides each wavevector's sign
        np.testing.assert_array_equal(np.sign(Kt.numpy()), np.sign(Kj))
        # the last bit of some wavevectors (see _spectrum_close): an ulp
        # of n ~ res on the wrapped n - res, up to 7.5e-6 relative
        np.testing.assert_allclose(Kt.numpy(), Kj, rtol=1e-5)
        np.testing.assert_allclose(kt.numpy(), kj, rtol=1e-5)
    for u in ((-5.0, 5.0), (7.0, 1.5)):
        want = np.asarray(jow.init_spectrum(np.asarray(u), 64, 15.0))
        got = tow.init_spectrum(u, 64, 15.0, device="cpu").numpy()
        assert got.dtype == np.float32
        _spectrum_close(got, want)


def test_seed_field_and_synthesize_match_jax():
    res, size = 32, 500.0
    spec_j = jow.init_spectrum(np.asarray([-5.0, 5.0]), res, size)
    spec_t = tow.init_spectrum((-5.0, 5.0), res, size, device="cpu")
    _spectrum_close(spec_t.numpy(), np.asarray(spec_j))
    h0j, hsj, p0j = (np.asarray(a) for a in jow.seed_field(
        jax.random.key(0), spec_j))
    # the draws alone: the same spectrum on both sides
    h0t, hst, p0t = tow.seed_field(prng.prng_key(0),
                                   torch.from_numpy(np.asarray(spec_j)))
    assert h0t.dtype == torch.complex64
    for got, want in ((h0t, h0j), (hst, hsj), (p0t, p0j)):
        _spectrum_close(got.numpy(), want)
    times = np.arange(6, dtype=np.float32) / np.float32(15.0)
    want = np.asarray(jow.synthesize(h0j, hsj, p0j, times, 1e4, res, size))
    got = tow.synthesize(torch.from_numpy(h0j), torch.from_numpy(hsj),
                         torch.from_numpy(p0j), times, 1e4, res,
                         size).numpy()
    assert got.shape == want.shape == (6, res, res, 3)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    # one phase step at t alone equals the batch's frame
    np.testing.assert_allclose(
        tow.evolve_phase(torch.from_numpy(p0j), float(times[3]), res,
                         size).numpy(),
        np.asarray(jow.evolve_phase(p0j, times[3], res, size)),
        rtol=1e-5, atol=1e-5)


def test_animate_gif_frames(tmp_path):
    pytest.importorskip("matplotlib")
    Image = pytest.importorskip("PIL.Image")
    kw = dict(resolution=16, frames=3, fps=5)
    assert jow.animate_gif(str(tmp_path / "j.gif"), **kw)
    assert tow.animate_gif(str(tmp_path / "t.gif"), device="cpu", **kw)
    shapes = []
    for name in ("j.gif", "t.gif"):
        with Image.open(tmp_path / name) as im:
            shapes.append((im.n_frames, im.size))
    assert shapes[0] == shapes[1] and shapes[0][0] == 3
