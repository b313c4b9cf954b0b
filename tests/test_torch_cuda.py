"""The CUDA kernels against their plain versions on the card. Needs an
NVIDIA GPU with nvcc; skips elsewhere. Run on the card with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(--noconftest: the repo's conftest imports JAX, which the card machine
does not have)."""
import numpy as np
import pytest
import torch

from ingp_tpu_torch.kernels import brickreduce as k2
from ingp_tpu_torch.kernels import composite as k3
from ingp_tpu_torch.kernels import rayreduce as k1

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    return torch.device("cuda")


def _lf(rng, *shape):
    loc = rng.integers(0, 2, (3,) + shape).astype(np.float32)
    loc[..., ::11] = -9.0
    frac = rng.uniform(0, 1, (3,) + shape).astype(np.float32)
    sc = np.full((1,) + shape, 21.0, np.float32)
    return torch.from_numpy(np.concatenate(
        [loc, frac, sc, np.zeros((1,) + shape, np.float32)]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("F", [4, 8])
def test_k1_matches_plain(cuda, dtype, F):
    rng = np.random.default_rng(0)
    B, U, K, W, R = 24, 48, 256, 32 * F, 700
    table = torch.from_numpy(rng.normal(size=(R, W)).astype(np.float32)
                             ).to(dtype)
    urows = torch.from_numpy(rng.integers(0, R, (B, U)).astype(np.int32))
    uid = torch.from_numpy(np.minimum(np.cumsum(rng.random((B, K)) < .2, 1),
                                      U - 1).astype(np.int32))
    lf = _lf(rng, B, K)
    ref = k1.fused_ray_reduce_plain(table, urows, uid, lf, F, True, 1, F - 1)
    n0 = k1.fused_ray_reduce.launches
    out = k1.fused_ray_reduce(table.to(cuda), urows.to(cuda), uid.to(cuda),
                              lf.to(cuda), F, True, 1, F - 1)
    torch.cuda.synchronize()
    assert k1.fused_ray_reduce.launches == n0 + 1
    for a, b in zip(out, ref):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2_matches_plain(cuda, dtype):
    rng = np.random.default_rng(1)
    F, W, Lw, N, R = 8, 256, 4, 3000, 500
    table = torch.from_numpy(rng.normal(size=(R, W)).astype(np.float32)
                             ).to(dtype)
    rows = torch.from_numpy(rng.integers(0, R, (Lw, N)).astype(np.int32))
    lf = _lf(rng, Lw, N)
    ref = k2.brick_reduce_plain(table, rows, lf, F, True)
    out = k2.brick_reduce(table.to(cuda), rows.to(cuda), lf.to(cuda), F,
                          True)
    torch.cuda.synchronize()
    for a, b in zip(out, ref):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-5, atol=1e-4)


def test_k3_matches_plain(cuda):
    rng = np.random.default_rng(2)
    R, S, C = 1000, 48, 13
    n = rng.integers(0, S + 1, R)
    valid = torch.from_numpy(np.arange(S)[None] < n[:, None])
    sig = torch.from_numpy(rng.uniform(0, 40, (R, S)).astype(np.float32))
    dt = torch.full((R, S), 0.0135)
    ts = torch.cumsum(dt, 1) + 0.3
    rgbs = torch.from_numpy(rng.uniform(0, 1, (3, R, S)).astype(np.float32))
    aux = torch.from_numpy(rng.normal(size=(C, R, S)).astype(np.float32))
    ref = k3.composite_plain(sig, dt, ts, valid, 1e-2, rgbs, aux, True)
    out = k3.composite(*(t.to(cuda) for t in (sig, dt, ts, valid)), 1e-2,
                       rgbs.to(cuda), aux.to(cuda), True)
    torch.cuda.synchronize()
    for k in ref:
        torch.testing.assert_close(out[k].cpu(), ref[k], rtol=1e-5,
                                   atol=1e-5, msg=k)
