"""Port parity of the hash-grid encoder (ingp_tpu_torch/ops/hashgrid.py
against ingp_tpu/ops/hashgrid.py) on CPU.

One config with dense and hashed levels (resolutions 4, 8 dense; 16, 32,
64, 128 hashed at a 2^10 map), F 2 and 8, f32 and bf16 storage. The
coordinates are uniform draws plus points at exactly 0, exactly 1 and
1e-3 outside the cube on each side (the corner clamp's edges).

Tolerances (measured values in brackets):
- the table rows of every corner equal to a numpy uint32 evaluation of
  the JAX formula (products wrapping mod 2^32);
- features and jacobian to rtol 1e-5 plus 1e-6 of the largest |value|
  [1.5e-7 and 8e-8 of the largest]. XLA's CPU code computes
  x * scale + 0.5 as a fused multiply-add, and the port rounds it once
  too; rounded twice, frac moved by an ulp of pos and the jacobian
  (scaled by up to 127) by 2e-6 of its largest value;
- the table and x gradients of a random cotangent of both outputs to
  1e-5 of the largest |value| [3e-6].
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ingp_tpu.ops import hashgrid as jh
from ingp_tpu_torch.core import prng
from ingp_tpu_torch.ops import hashgrid as th
from tests._torch_threads import one_torch_thread  # noqa: F401

KW = dict(n_levels=6, log2_hashmap_size=10, base_resolution=4,
          per_level_scale=2.0)


def _inputs(F, seed=0, n=600):
    cfg = jh.HashGridConfig(n_features=F, **KW)
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(F, cfg.total_rows)).astype(np.float32)
    x = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    x[:8] = 0.0
    x[8:16] = 1.0
    x[16:24] = -1e-3
    x[24:32] = 1.0 + 1e-3
    x[32:40, 0] = 1.0
    x[40:48, 1] = 0.0
    return cfg, th.HashGridConfig(n_features=F, **KW), table, x, rng


def test_config_matches():
    for F in (2, 8):
        cj, ct, *_ = _inputs(F)
        for k in ("scales", "resolutions", "hashed", "offsets", "total_rows",
                  "out_dim", "hashmap_size"):
            assert getattr(ct, k) == getattr(cj, k), k
        assert any(ct.hashed) and not all(ct.hashed)


def _rows_uint32(cfg, x):
    """The JAX encoder's corner rows, in numpy uint32 arithmetic."""
    L = cfg.n_levels
    sc = np.asarray(cfg.scales, np.float32)
    res = np.asarray(cfg.resolutions, np.int64)[:, None]
    pos = x.T[:, None, :] * sc[None, :, None] + np.float32(0.5)
    g = np.floor(pos).astype(np.int64)
    out = []
    for c in range(8):
        bits = np.array([c & 1, (c >> 1) & 1, (c >> 2) & 1])[:, None, None]
        cu = np.clip(g + bits, 0, res[None] - 1).astype(np.uint32)
        with np.errstate(over="ignore"):
            h = (cu[0] * np.uint32(1) ^ cu[1] * np.uint32(2654435761)
                 ^ cu[2] * np.uint32(805459861)) \
                & np.uint32(cfg.hashmap_size - 1)
        ru = res.astype(np.uint32)
        dense = (cu[2] * ru + cu[1]) * ru + cu[0]
        rows = np.where(np.asarray(cfg.hashed)[:, None], h, dense) \
            + np.asarray(cfg.offsets, np.uint32)[:, None]
        out.append(rows.astype(np.int64).reshape(L, -1))
    return out


def test_corner_rows_exact():
    cj, ct, _, x, _ = _inputs(8)
    ref = _rows_uint32(cj, x)
    sc = torch.tensor(ct.scales)
    pos = torch.tensor(x).T[:, None, :] * sc[None, :, None] + 0.5
    g = torch.floor(pos).to(torch.int64)
    res = torch.tensor(ct.resolutions)[None, :, None]
    for c in range(8):
        b = torch.tensor([c & 1, (c >> 1) & 1, (c >> 2) & 1])[:, None, None]
        corner = torch.minimum(torch.clamp(g + b, min=0), res - 1)
        rows = th.corner_rows(ct, corner).numpy()
        np.testing.assert_array_equal(rows, ref[c], err_msg=f"corner {c}")
        assert rows.max() < ct.total_rows


@pytest.mark.parametrize("F", [2, 8])
@pytest.mark.parametrize("storage", [None, "bfloat16"])
def test_encode_and_grads_match(F, storage):
    cj, ct, table, x, rng = _inputs(F)
    sd_j = None if storage is None else jnp.bfloat16
    f_j = jh.hashgrid_encode(cj, jnp.asarray(table), jnp.asarray(x),
                             storage_dtype=sd_j)
    fg_j, jac_j = jh.hashgrid_encode_grad(cj, jnp.asarray(table),
                                          jnp.asarray(x), storage_dtype=sd_j)
    tab_t = torch.tensor(table.T.copy(), requires_grad=True)
    x_t = torch.tensor(x, requires_grad=True)
    f_t = th.hashgrid_encode(ct, tab_t, x_t, storage_dtype=storage)
    fg_t, jac_t = th.hashgrid_encode_grad(ct, tab_t, x_t,
                                          storage_dtype=storage)
    # channel-major input gives the same values
    f_cm = th.hashgrid_encode(ct, tab_t, x_t.T, storage_dtype=storage,
                              x_cm=True)
    assert torch.equal(f_cm, f_t)
    for a, b in ((f_t, f_j), (fg_t, fg_j), (jac_t, jac_j)):
        b = np.asarray(b)
        assert a.shape == b.shape
        np.testing.assert_allclose(a.detach().numpy(), b, rtol=1e-5,
                                   atol=1e-6 * np.abs(b).max())

    cf = rng.normal(size=f_t.shape).astype(np.float32)
    cjac = rng.normal(size=jac_t.shape).astype(np.float32)

    def loss_j(t, xx):
        f, j = jh.hashgrid_encode_grad(cj, t, xx, storage_dtype=sd_j)
        return (f * cf).sum() + (j * cjac).sum()

    g_tab, g_x = jax.grad(loss_j, argnums=(0, 1))(jnp.asarray(table),
                                                  jnp.asarray(x))
    ((fg_t * torch.tensor(cf)).sum()
     + (jac_t * torch.tensor(cjac)).sum()).backward()
    for a, b in ((tab_t.grad.T, g_tab), (x_t.grad, g_x)):
        b = np.asarray(b)
        assert tab_t.grad.dtype == torch.float32
        err = np.abs(a.numpy() - b).max()
        assert err <= 1e-5 * np.abs(b).max(), (err, np.abs(b).max())


def test_no_grad_read_and_init():
    _, ct, table, x, _ = _inputs(2)
    tab = torch.tensor(table.T.copy())
    with torch.no_grad():
        a = th.hashgrid_encode(ct, tab.requires_grad_(), torch.tensor(x))
    assert not a.requires_grad
    t = th.hashgrid_init(ct, prng.prng_key(0))
    assert t.shape == (ct.total_rows, 2) and t.dtype == torch.float32
    assert float(t.abs().max()) <= 1e-4
    # the JAX package's (F, total_rows) draw from the same key, transposed
    cj = jh.HashGridConfig(n_features=2, **KW)
    np.testing.assert_array_equal(
        t.numpy(), np.asarray(jh.hashgrid_init(jax.random.PRNGKey(0), cj)).T)
