"""Ocean-wave spectrum playground (counterpart of
ingp_tpu/utility/ocean_wave.py, itself a rebuild of the reference's
utility/test_dynamic.py:1-188).

An Elfouhaily-style unified wave spectrum (a JONSWAP-peaked long-wave
branch, a capillary short-wave branch and a directional spreading term),
seeded with complex Gaussian noise, its per-wavevector phases advanced
by omega(k) = sqrt(g k (1 + (k/KM)^2)), and each timestep inverse-FFT'd
into a displaced heightfield. Everything from the spectrum to the
displacement fields runs on the device in complex64 / float32, a whole
animation as one batched `ifft2` over the stacked frames; the GIF is an
optional matplotlib tail that returns False where matplotlib is missing.
The draws are the JAX package's (`core/prng.py`), and so are its kept
quirks: the JONSWAP `sigma` multiplies the exponent, and the mirrored
spectrum `h0_star` is flipped, not conjugated.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core import prng
from ..device import resolve_device

G = 9.81        # gravity [m/s^2]
KM = 370.0      # capillary-gravity crossover wavenumber [rad/m]
CM = 0.23       # phase speed minimum [m/s]
_F32 = torch.float32


def dispersion(k):
    """Deep-water + capillary dispersion omega(k)."""
    return torch.sqrt(G * k * (1.0 + (k / KM) ** 2))


def _lattice(res: int):
    """jnp.linspace(0.5, res + 0.5, res) in float32 as XLA evaluates it:
    i / (res - 1) as i times the rounded reciprocal c, stop * i / (res - 1)
    folded into i times the rounded constant stop * c, and the sum
    start (1 - i c) + i (stop c) fused (one rounding; the f64 sum of the
    two float32 terms is exact)."""
    if res == 1:
        return torch.tensor([0.5])
    c = np.float32(1) / np.float32(res - 1)
    c_stop = float(np.float32(np.float32(res + 0.5) * c))
    i = torch.arange(res - 1, dtype=_F32)
    head = (0.5 * (1.0 - i * float(c))).double()
    return torch.cat([(i.double() * c_stop + head).to(_F32),
                      torch.tensor([res + 0.5])])


def wave_vectors(resolution: int = 512, size: float = 15.0, device=None):
    """Signed FFT-ordered wavevector lattice (K (res, res, 2) in rad/m,
    k its magnitude), float32: the first half of each axis positive, the
    second wrapped negative, on the JAX package's lattice (`_lattice`)."""
    dev = resolve_device(device)
    coord = _lattice(resolution).to(dev)
    n, m = torch.meshgrid(coord, coord, indexing="xy")
    n = torch.where(n < resolution * 0.5, n, n - resolution)
    m = torch.where(m < resolution * 0.5, m, m - resolution)
    K = torch.stack([n, m], 2) * _two_pi_over(size)
    return K, torch.linalg.norm(K, dim=2)


def _F(x):
    """A Python float rounded to float32: a constant as the JAX package's
    float32 arithmetic sees it (Python scalars combine with float32
    arrays as float32)."""
    return float(np.float32(x))


def _two_pi_over(size):
    """2 pi / size in float32 arithmetic, as the JAX package divides by
    its traced float32 `size`."""
    return _F(np.float32(2.0 * math.pi) / np.float32(size))


def init_spectrum(u_wind, resolution: int = 512, size: float = 15.0,
                  device=None):
    """Per-wavevector wave amplitude sqrt(S/2) dk (res, res) float32."""
    dev = resolve_device(device)
    u_wind = torch.as_tensor(np.asarray(u_wind, np.float32), device=dev)
    inv_age = 0.84
    gamma = 1.7
    sigma = 0.08 * (1.0 + 4.0 * inv_age ** -3.0)
    alpha_p = 0.006 * _F(math.sqrt(_F(inv_age)))

    K, k = wave_vectors(resolution, size, dev)
    wind_speed = torch.linalg.norm(u_wind)
    kp = G * (inv_age / wind_speed) ** 2
    c = dispersion(k) / k
    cp = dispersion(kp) / kp

    cutoff = torch.exp(-1.25 * (kp / k) ** 2)
    peak_arg = torch.exp(-((torch.sqrt(k / kp) - 1.0) ** 2) / 2.0
                         * _F(sigma ** 2))
    jonswap = torch.pow(torch.tensor(gamma, dtype=_F32, device=dev),
                        peak_arg)
    Fp = (cutoff * jonswap
          * torch.exp(_F(_F(-inv_age) / _F(math.sqrt(_F(10.0))))
                      * (torch.sqrt(k / kp) - 1.0)))
    Bl = _F(0.5 * _F(alpha_p)) * (cp / c) * Fp

    z0 = 0.000037 * wind_speed ** 2 / G * (wind_speed / cp) ** 0.9
    u_star = 0.41 * wind_speed / torch.log(10.0 / z0)
    alpha_m = 0.01 * torch.where(u_star < CM,
                                 1.0 + torch.log(u_star / CM),
                                 1.0 + 3.0 * torch.log(u_star / CM))
    Fm = torch.exp(-0.25 * (k / KM - 1.0) ** 2)
    Bh = 0.5 * alpha_m * (CM / c) * Fm * cutoff

    a0 = _F(_F(math.log(_F(2.0))) / 4.0)
    am = 0.13 * u_star / CM
    spread = torch.tanh(a0 + 4.0 * (c / cp) ** 2.5
                        + am * (CM / c) ** 2.5)
    cos_phi = (K / k[..., None]) @ (u_wind / wind_speed)

    S = (_F(1.0 / (2.0 * math.pi)) * k ** -4.0 * (Bl + Bh)
         * (1.0 + spread * (2.0 * cos_phi ** 2 - 1.0)))
    return torch.sqrt(S / 2.0) * _two_pi_over(size)


def seed_field(key, spectrum):
    """Complex-Gaussian-seeded initial field h0 (complex64), its flipped
    partner and the initial phases, from a `core.prng` key as the JAX
    package draws them."""
    kr, ki, kp = prng.split(key, 3)
    res, dev = spectrum.shape[0], spectrum.device
    h0 = torch.complex(prng.normal(kr, (res, res), dev),
                       prng.normal(ki, (res, res), dev)) * spectrum
    return h0, torch.flip(h0, (0, 1)), prng.normal(kp, (res, res), dev)


def evolve_phase(phase0, t, resolution: int = 512, size: float = 250.0):
    """Phases advanced by omega(k) t, modulo 2 pi. t: a scalar or (T,)
    times, giving (res, res) or (T, res, res)."""
    _, k = wave_vectors(resolution, size, phase0.device)
    t = torch.as_tensor(t, dtype=_F32, device=phase0.device)
    w = dispersion(k)
    if t.dim():
        w, t = w[None], t[:, None, None]
    return torch.remainder(phase0 + w * t, _F(2.0 * math.pi))


def synthesize(h0, h0_star, phase0, times, amplitude: float = 1e4,
               resolution: int = 512, size: float = 500.0):
    """Displacement fields (T, res, res, 3) float32 of a batch of times
    in one batched ifft2: the lateral chop (dX, dY) from the phase shift
    i K_hat and the height dZ."""
    K, k = wave_vectors(resolution, size, h0.device)
    k_hat = K / torch.where(k[..., None] == 0, 1.0, k[..., None])
    rot = torch.polar(torch.ones((), device=h0.device),
                      evolve_phase(phase0, np.asarray(times, np.float32),
                                   resolution, size))
    eta = torch.fft.ifft2(h0[None] * rot + h0_star[None] * rot.conj())
    dz = eta.real * amplitude
    chop = (eta * 1j).real * amplitude
    return torch.stack([chop * k_hat[None, ..., 0],
                        chop * k_hat[None, ..., 1], dz], -1).to(_F32)


def animate_gif(path: str, u_wind=(-5.0, 5.0), resolution: int = 512,
                size: float = 500.0, frames: int = 120,
                freq: float = 15.0, amplitude: float = 1e4,
                fps: int = 10, seed: int = 0, device=None) -> bool:
    """The reference's 3D surface GIF: every frame synthesised on the
    device first, matplotlib only replays host arrays. Returns False
    (and writes nothing) where matplotlib is not installed, as the JAX
    package does."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        from matplotlib import cm
        from matplotlib.animation import FuncAnimation, PillowWriter
    except Exception:
        return False

    dev = resolve_device(device)
    spec = init_spectrum(u_wind, resolution, size, dev)
    h0, h0_star, phase0 = seed_field(prng.prng_key(seed), spec)
    times = np.arange(frames, dtype=np.float32) / np.float32(freq)
    disp = synthesize(h0, h0_star, phase0, times, amplitude, resolution,
                      size).cpu().numpy()

    fig, ax = plt.subplots(subplot_kw={"projection": "3d"},
                           figsize=(8, 8))
    lin = np.linspace(-1, 1, resolution)
    X, Y = np.meshgrid(lin, lin)

    def draw(i):
        ax.clear()
        dx, dy, dz = disp[i, ..., 0], disp[i, ..., 1], disp[i, ..., 2]
        surf = ax.plot_surface(X + dx, Y + dy, dz, rstride=4, cstride=4,
                               linewidth=0, cmap=cm.coolwarm,
                               antialiased=False)
        ax.set_zlim(-1.01, 1.01)
        return surf

    ani = FuncAnimation(fig, draw, frames=frames, interval=1,
                        blit=False, repeat=True)
    ani.save(path, dpi=72, writer=PillowWriter(fps=fps))
    plt.close(fig)
    return True
