"""The CUDA kernels against their plain versions on the card. Needs an
NVIDIA GPU with nvcc; skips elsewhere. Run on the card with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(--noconftest: the repo's conftest imports JAX, which the card machine
does not have)."""
import numpy as np
import pytest
import torch

from ingp_tpu_torch.kernels import brickreduce as k2
from ingp_tpu_torch.kernels import build
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
    n0 = build.LAUNCHES["ingp_ray_reduce_fwd"]
    out = k1.fused_ray_reduce(table.to(cuda), urows.to(cuda), uid.to(cuda),
                              lf.to(cuda), F, True, 1, F - 1)
    torch.cuda.synchronize()
    assert build.LAUNCHES["ingp_ray_reduce_fwd"] == n0 + 1
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


# Backward kernels. Each cell's per-lane cotangent has the same bits in
# the kernel as in the plain version (every operation rounded on its own,
# in one order), and K1 sums a slot's cells in the same order; only the
# f32 atomic adds into the master gradient run in another order, so the
# kernels agree with the plain versions on the CPU to 1e-5 of the
# largest |value|, bf16 rounding included.

def _close(out, ref):
    scale = float(ref.abs().max())
    assert scale > 0
    assert float((out.cpu() - ref).abs().max()) <= 1e-5 * scale


def _on(t, cuda, mask=None):
    """t on the card (times mask), or None."""
    if t is None:
        return None
    t = t.to(cuda)
    return t if mask is None else t * mask


# with_dj False: a forward without a jacobian (the rgb table, the grid
# refresh) gives the backward no jacobian cotangent
@pytest.mark.parametrize("with_dj", [True, False])
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("F,window", [(8, (0, None)), (4, (1, 3))])
def test_k1_bwd_matches_plain(cuda, bf16, F, window, with_dj):
    rng = np.random.default_rng(3)
    B, U, K, R = 24, 48, 256, 300
    W = 32 * F
    jac_lo, jac_hi = window
    Fj = (F if jac_hi is None else jac_hi) - jac_lo
    urows = torch.from_numpy(rng.integers(0, R, (B, U)).astype(np.int32))
    uid = torch.from_numpy(np.minimum(np.cumsum(rng.random((B, K)) < .2, 1),
                                      U - 1).astype(np.int32))
    lf = _lf(rng, B, K)
    df = torch.from_numpy(rng.normal(size=(F, B, K)).astype(np.float32))
    dj = torch.from_numpy(rng.normal(size=(3 * Fj, B, K)).astype(np.float32)
                          ) if with_dj else None
    ref = k1.fused_ray_reduce_bwd_plain(torch.zeros(R, W), urows, uid, lf,
                                        df, dj, F, jac_lo, jac_hi, bf16)
    n0 = build.LAUNCHES["ingp_ray_reduce_bwd"]
    out = k1.fused_ray_reduce_bwd(
        torch.zeros((R, W), device=cuda), urows.to(cuda), uid.to(cuda),
        lf.to(cuda), df.to(cuda), _on(dj, cuda), F, jac_lo, jac_hi, bf16)
    torch.cuda.synchronize()
    assert build.LAUNCHES["ingp_ray_reduce_bwd"] == n0 + 1
    _close(out, ref)
    # cotangents only on the cells marked -9: exactly nothing is added
    marked = (lf[0] < 0).to(cuda)
    out = k1.fused_ray_reduce_bwd(
        torch.zeros((R, W), device=cuda), urows.to(cuda), uid.to(cuda),
        lf.to(cuda), df.to(cuda) * marked, _on(dj, cuda, marked), F, jac_lo,
        jac_hi, bf16)
    assert not bool(out.any())


@pytest.mark.parametrize("with_dj", [True, False])
@pytest.mark.parametrize("bf16", [False, True])
def test_k2_bwd_matches_plain(cuda, bf16, with_dj):
    rng = np.random.default_rng(4)
    F, W, Lw, N, R = 8, 256, 4, 3000, 500
    rows = torch.from_numpy(rng.integers(0, R, (Lw, N)).astype(np.int32))
    lf = _lf(rng, Lw, N)
    df = torch.from_numpy(rng.normal(size=(N, Lw * F)).astype(np.float32))
    dj = torch.from_numpy(rng.normal(size=(3, N, Lw * F)).astype(np.float32)
                          ) if with_dj else None
    ref = k2.brick_reduce_bwd_plain(torch.zeros(R, W), rows, lf, df, dj, F,
                                    bf16=bf16)
    out = k2.brick_reduce_bwd(torch.zeros((R, W), device=cuda),
                              rows.to(cuda), lf.to(cuda), df.to(cuda),
                              _on(dj, cuda), F, bf16=bf16)
    torch.cuda.synchronize()
    _close(out, ref)
    marked = (lf[0] < 0).T.repeat_interleave(F, 1).to(cuda)      # (N, Lw*F)
    out = k2.brick_reduce_bwd(torch.zeros((R, W), device=cuda),
                              rows.to(cuda), lf.to(cuda),
                              df.to(cuda) * marked, _on(dj, cuda, marked),
                              F, bf16=bf16)
    assert not bool(out.any())


def test_k3_bwd_matches_plain(cuda):
    rng = np.random.default_rng(5)
    R, S, C = 1000, 48, 13
    n = rng.integers(0, S + 1, R)
    valid = torch.from_numpy(np.arange(S)[None] < n[:, None])
    sig = torch.from_numpy(rng.uniform(0, 40, (R, S)).astype(np.float32))
    dt = torch.full((R, S), 0.0135)
    ts = torch.cumsum(dt, 1) + 0.3
    rgbs = torch.from_numpy(rng.uniform(0, 1, (3, R, S)).astype(np.float32))
    aux = torch.from_numpy(rng.normal(size=(C, R, S)).astype(np.float32))
    cts = [torch.from_numpy(rng.normal(size=s).astype(np.float32))
           for s in ((R, S), (R,), (R,), (R, 3), (R, C))]
    ref = k3.composite_bwd_plain(sig, dt, ts, valid, 1e-2, rgbs, aux, *cts)
    out = k3.composite_bwd(*(t.to(cuda) for t in (sig, dt, ts, valid)), 1e-2,
                           rgbs.to(cuda), aux.to(cuda),
                           *(t.to(cuda) for t in cts))
    torch.cuda.synchronize()
    for a, b in zip(out, ref):
        _close(a, b)


@pytest.mark.parametrize("probe", ["kernel_split", "row_layouts",
                                   "vmem_gather", "gather_layouts"])
def test_probe_kernels_match_plain(cuda, probe):
    """Every variant of each probe kernel against its plain version on
    the card, at small sizes (chip_smoke.py checks the probes' full
    shapes): gathers bitwise, the K1 split to K1's tolerances."""
    import importlib
    from ingp_tpu_torch.probes import common
    mod = importlib.import_module(f"ingp_tpu_torch.probes.{probe}")
    kw = {"kernel_split": dict(groups=((24, 12), (16, 40)), n_rows=700,
                               fwd_modes=["full", "shipping", "no-planes",
                                          "no-expand", "no-dot",
                                          "bf16-planes", "rowpair-2",
                                          "rowpair-4"]),
          "row_layouts": dict(shapes=(((256,), torch.bfloat16, 5000, 3000),
                                      ((16, 128), torch.bfloat16, 700, 300),
                                      ((8, 128), torch.float32, 700, 300))),
          "vmem_gather": dict(rows=1000, n=3000),
          "gather_layouts": dict(big_rows=1000)}[probe]
    cases = mod.cases(cuda, **kw)
    for c in cases:
        n0 = build.LAUNCHES[c.symbol]
        common.compare(c)
        assert build.LAUNCHES[c.symbol] > n0, c.variant
    torch.cuda.synchronize()
