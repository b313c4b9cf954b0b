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
@pytest.mark.parametrize("F", [4, 8, 16])
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


@pytest.mark.parametrize("W,n", [(256, 3001), (4, 1000), (1000, 517),
                                  (7000, 33)])
def test_onchip_ring_rows_and_zero_rows(cuda, W, n):
    """The on-chip gather's L2 form (the TMA ring) bitwise against its
    plain version: rows of 16 bytes to 28 KB (32 to 1 rows a stage), a
    ragged last tile, ids outside the table give zero rows; rows past
    the ring's stage are refused."""
    from ingp_tpu_torch.probes import vmem_gather as vg
    gen = torch.Generator(device=cuda).manual_seed(W)
    table = torch.randn((300, W), generator=gen, device=cuda)
    idx = torch.randint(-3, 303, (n,), generator=gen, device=cuda,
                        dtype=torch.int32)
    ref = vg.gather_rows_plain(table, idx)
    assert torch.equal(vg.gather_rows(table, idx, "l2"), ref)
    with pytest.raises(ValueError):
        vg.gather_rows(torch.zeros((4, 7172), device=cuda), idx[:4], "l2")


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
@pytest.mark.parametrize("F,window", [(8, (0, None)), (4, (1, 3)),
                                      (16, (0, 8))])
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


# The redesigned K1 backward (a warp per run and 32 lanes, each slot's
# cells summed in k order) and K2 forward (tiles of S samples x Lw
# levels, outputs staged and written as contiguous slabs): training's
# shapes and the plans that stress the design. With each slot its own
# table row the f32 atomics cannot reorder anything, so the K1 backward
# must give the plain version's bits exactly.

def _k1_plan(rng, kind, B, K, U):
    """uid (B, K) and the overflow mask of a plan: "training" (runs of ~9
    cells, the cap U clipping the tail to -9 as the stream does), "one
    slot" (a slot spanning the row), "every cell" (each cell its own
    slot), "long rows" (K > 256: runs across the kernel's 256-cell
    chunks, one longer than a chunk), "outside" (uids outside [0, U)
    inside runs and at the ends)."""
    if kind == "one slot":
        return np.zeros((B, K), np.int32), np.zeros((B, K), bool)
    if kind == "every cell":
        return np.tile(np.arange(K, dtype=np.int32), (B, 1)), \
            np.zeros((B, K), bool)
    new = rng.random((B, K)) < (0.02 if kind == "long rows" else 1 / 9)
    new[:, 0] = True
    run = np.cumsum(new, 1)
    uid = np.minimum(run - 1, U - 1).astype(np.int32)
    if kind == "outside":
        uid[:, 7:11] = U + 5
        uid[::2, :3] = -1
        uid[1::3, -2:] = U
    return uid, run > U


def _k1_bwd_inputs(rng, kind, B, K, U, F=8):
    uid, ovf = _k1_plan(rng, kind, B, K, U)
    lf = _lf(rng, B, K)
    lf[0:3][:, torch.from_numpy(ovf)] = -9.0
    df = torch.from_numpy(rng.normal(size=(F, B, K)).astype(np.float32))
    dj = torch.from_numpy(rng.normal(size=(3 * F, B, K)).astype(np.float32))
    return torch.from_numpy(uid), lf, df, dj


@pytest.mark.parametrize("bf16", [True, False])
@pytest.mark.parametrize("kind,B,K,U", [("training", 768, 256, 192),
                                        ("one slot", 32, 256, 192),
                                        ("every cell", 32, 256, 256),
                                        ("long rows", 16, 600, 192),
                                        ("outside", 64, 256, 192)])
def test_k1_bwd_plans_bitwise(cuda, bf16, kind, B, K, U):
    rng = np.random.default_rng(7)
    uid, lf, df, dj = _k1_bwd_inputs(rng, kind, B, K, U)
    urows = torch.arange(B * U, dtype=torch.int32).reshape(B, U)
    ref = k1.fused_ray_reduce_bwd_plain(torch.zeros(B * U, 256), urows, uid,
                                        lf, df, dj, 8, bf16=bf16)
    out = k1.fused_ray_reduce_bwd(
        torch.zeros((B * U, 256), device=cuda), urows.to(cuda), uid.to(cuda),
        lf.to(cuda), df.to(cuda), dj.to(cuda), 8, bf16=bf16)
    torch.cuda.synchronize()
    assert float(ref.abs().max()) > 0
    assert torch.equal(out.cpu(), ref)


@pytest.mark.parametrize("bf16", [True, False])
@pytest.mark.parametrize("kind,B,K,U", [("training", 384, 256, 64),
                                        ("long rows", 16, 600, 192),
                                        ("outside", 64, 256, 192)])
def test_k1_bwd_f16_plans_bitwise(cuda, bf16, kind, B, K, U):
    """The fused encoder's launches: F = 16, jacobian window [0, 8), each
    slot its own row, bf16 staging in two 16-byte words a corner."""
    rng = np.random.default_rng(17)
    uid, lf, df, dj = _k1_bwd_inputs(rng, kind, B, K, U, 16)
    dj = dj[:24].contiguous()
    urows = torch.arange(B * U, dtype=torch.int32).reshape(B, U)
    ref = k1.fused_ray_reduce_bwd_plain(torch.zeros(B * U, 512), urows, uid,
                                        lf, df, dj, 16, 0, 8, bf16)
    n0 = build.LAUNCHES["ingp_ray_reduce_bwd"]
    out = k1.fused_ray_reduce_bwd(
        torch.zeros((B * U, 512), device=cuda), urows.to(cuda), uid.to(cuda),
        lf.to(cuda), df.to(cuda), dj.to(cuda), 16, 0, 8, bf16)
    torch.cuda.synchronize()
    assert build.LAUNCHES["ingp_ray_reduce_bwd"] == n0 + 1
    assert float(ref.abs().max()) > 0
    assert torch.equal(out.cpu(), ref)


def test_k1_bwd_training_shapes(cuda):
    """Training's recorded launch: uid (768, 256), U 192, F = Fj = 8,
    bf16, slots on rows of a density-sized table (rows shared between
    slots: only the f32 atomic order differs from the plain version)."""
    rng = np.random.default_rng(8)
    B, K, U, R = 768, 256, 192, 207_295
    uid, lf, df, dj = _k1_bwd_inputs(rng, "training", B, K, U)
    urows = torch.from_numpy(rng.integers(0, R, (B, U)).astype(np.int32))
    ref = k1.fused_ray_reduce_bwd_plain(torch.zeros(R, 256), urows, uid, lf,
                                        df, dj, 8, bf16=True)
    out = k1.fused_ray_reduce_bwd(
        torch.zeros((R, 256), device=cuda), urows.to(cuda), uid.to(cuda),
        lf.to(cuda), df.to(cuda), dj.to(cuda), 8, bf16=True)
    torch.cuda.synchronize()
    _close(out, ref)


def test_k1_bwd_needs_16_byte_rows(cuda):
    """The kernel adds each lattice point's lanes with 16-byte atomics:
    the wrapper refuses a gradient whose rows are not 16-byte aligned
    and launches nothing."""
    rng = np.random.default_rng(11)
    uid, lf, df, dj = _k1_bwd_inputs(rng, "training", 4, 256, 16)
    urows = torch.zeros((4, 16), dtype=torch.int32, device=cuda)
    args = (urows, uid.to(cuda), lf.to(cuda), df.to(cuda), dj.to(cuda), 8)
    n0 = build.LAUNCHES["ingp_ray_reduce_bwd"]
    shifted = torch.zeros(40 * 256 + 1, device=cuda)[1:].view(40, 256)
    with pytest.raises(ValueError):
        k1.fused_ray_reduce_bwd(shifted, *args)
    with pytest.raises(ValueError):
        k1.fused_ray_reduce_bwd(torch.zeros((40, 218), device=cuda), *args)
    assert build.LAUNCHES["ingp_ray_reduce_bwd"] == n0


@pytest.mark.parametrize("Lw,N,F,window,dtype", [
    (4, 196_608, 8, (0, None), torch.bfloat16),    # training, density
    (16, 65_536, 8, None, torch.bfloat16),         # the grid refresh
    (4, 3_037, 8, (0, None), torch.float32),       # a ragged last tile
    (16, 1_000, 8, (0, None), torch.bfloat16),     # Lw 16 with the jacobian
    (3, 1_001, 4, (1, 3), torch.float32),          # S*Lw < 256, odd planes
    (5, 77, 2, (1, 2), torch.bfloat16),
    (11, 40_000, 16, (0, 8), torch.bfloat16),      # fused, direct levels
    (16, 3_037, 16, (0, 8), torch.float32),        # fused, per sample
    (16, 5_000, 16, None, torch.bfloat16)])        # fused, grid refresh
def test_k2_tiles_match_plain(cuda, Lw, N, F, window, dtype):
    rng = np.random.default_rng(9)
    W, R = 32 * F, 2_000
    table = torch.from_numpy(rng.normal(size=(R, W)).astype(np.float32)
                             ).to(dtype)
    rows = torch.from_numpy(rng.integers(0, R, (Lw, N)).astype(np.int32))
    rows[:, ::13] = R + 3                             # outside the table
    lf = _lf(rng, Lw, N)
    with_jac = window is not None
    jac_lo, jac_hi = window if with_jac else (0, None)
    ref = k2.brick_reduce_plain(table, rows, lf, F, with_jac, jac_lo, jac_hi)
    n0 = build.LAUNCHES["ingp_brick_reduce_fwd"]
    out = k2.brick_reduce(table.to(cuda), rows.to(cuda), lf.to(cuda), F,
                          with_jac, jac_lo, jac_hi)
    torch.cuda.synchronize()
    assert build.LAUNCHES["ingp_brick_reduce_fwd"] == n0 + 1
    for a, b in zip(out, ref):
        if b is None:
            assert a is None
            continue
        scale = float(b.abs().max())
        assert float((a.cpu() - b).abs().max()) <= 1e-5 * scale + 1e-7
    zero = ((lf[0] < 0) | (rows >= R)).T                 # (N, Lw)
    assert not bool(out[0].cpu().reshape(N, Lw, F)[zero].any())


@pytest.mark.parametrize("with_jac", [True, False])
def test_k2_matches_old_body(cuda, with_jac):
    """The redesigned K2 forward against the body it replaced (the K2
    split's `full`) on the card: the same per-cell arithmetic."""
    from ingp_tpu_torch.probes import kernel_split as ps
    rng = np.random.default_rng(10)
    Lw, N, R = 4, 20_000, 3_000
    table = torch.from_numpy(rng.normal(size=(R, 256)).astype(np.float32)
                             ).to(torch.bfloat16).to(cuda)
    rows = torch.from_numpy(rng.integers(0, R, (Lw, N)).astype(np.int32)
                            ).to(cuda)
    lf = _lf(rng, Lw, N).to(cuda)
    new = k2.brick_reduce(table, rows, lf, 8, with_jac)
    old = ps.split_k2("full", table, rows, lf, with_jac)
    for a, b in zip(new, old):
        if b is not None:
            scale = float(b.abs().max())
            assert float((a - b).abs().max()) <= 1e-5 * scale + 1e-7


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
                                          "rowpair-4"],
                               k2_groups=(("Lw 4, jac", 4, 3_000, True),
                                          ("Lw 16, no jac", 16, 700,
                                           False)),
                               k2_rows=900,
                               k2b_groups=(("Lw 4, jac", 4, 3_000, True,
                                            900),
                                           ("Lw 4, no jac", 4, 2_001, False,
                                            1_300)),
                               k3b_shape=(1_000, 48, 13)),
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
    if probe == "gather_layouts":
        _gather_edges(cuda, mod)


def _gather_edges(cuda, pg):
    """The in-block gathers beyond the probe's shapes (`edge_checks`:
    both axis-0 bodies at ragged row counts on both sides of the switch
    to the slab and at their largest tables, every flat place at the
    largest table it takes and at ragged table and id counts, the ops
    that take 4-byte-aligned tensors on views 4 bytes into their storage,
    bitwise), each launch as the numpy model in
    tests/test_torch_gather_redesign.py plans it; one more entry or row
    than an op takes, and such views for the ops that need 16 bytes,
    refused; at least 32 blocks for the new bodies at the probe's
    shapes."""
    # pytest puts tests/ on sys.path (it holds no package); `tests.` may
    # name another package installed on the card's machine, so the
    # module's own `tests._torch_threads` import is given this
    # directory's module
    import sys
    import _torch_threads
    sys.modules.setdefault("tests._torch_threads", _torch_threads)
    from test_torch_gather_redesign import plan
    for op, t_shape, i_shape in pg.edge_checks(cuda):
        assert pg.launch_shape(op, t_shape, i_shape) == {
            k: v for k, v in plan(op, t_shape, i_shape).items()
            if k != "part"}, (op, t_shape, i_shape)
    idx = torch.zeros((2, 32), dtype=torch.int32, device=cuda)
    for where in ("cluster", "cluster before"):
        with pytest.raises(ValueError):
            pg.take_flat(torch.zeros(pg.flat_limit(where) + 2,
                                     dtype=torch.int32, device=cuda),
                         idx, where)
    for before, rows in ((False, pg.AXIS0_MAX_ROWS),
                         (True, pg.AXIS0_BEFORE_MAX_ROWS)):
        with pytest.raises(ValueError):
            pg.take_axis0(torch.zeros((rows + 1, 32), dtype=torch.int32,
                                      device=cuda), idx, before)
    table = torch.zeros((512, 128), dtype=torch.int32, device=cuda)
    ids = torch.zeros((256, 128), dtype=torch.int32, device=cuda)
    for t, i in ((pg.shifted(table), ids), (table, pg.shifted(ids))):
        with pytest.raises(ValueError, match="16-byte aligned"):
            pg.take_axis0(t, i)
        with pytest.raises(ValueError, match="16-byte aligned"):
            pg.take_flat(t, i)
    for op, t_shape, i_shape in (("axis0", (512, 128), (256, 128)),
                                 ("axis0", (512, 128), (8192, 128)),
                                 ("cluster", (65_536,), (256, 128))):
        gx, gy = pg.launch_shape(op, t_shape, i_shape)["grid"]
        assert gx * gy >= 32, (op, i_shape)
    torch.cuda.synchronize()


# The redesigned K2 backward (tiles of S samples x Lw levels, cotangent
# rows staged at the caller's row stride, a thread per cell adding its
# corners with 16-byte atomics) and K3 backward (a warp per ray, segments
# of 32 samples, the forward's serial csum).

def _k2b_case(rng, Lw, N, F, Fj, R, own_rows, with_dj):
    """A function of the device giving rows (each cell its own row with
    own_rows), lf with -9 cells and rows outside the table, and df and
    dj as column slices of wider tensors made on that device (torch.cat's
    backward hands over such views)."""
    if own_rows:
        rows = torch.arange(Lw * N, dtype=torch.int32).reshape(Lw, N)
    else:
        rows = torch.from_numpy(rng.integers(0, R, (Lw, N)).astype(np.int32))
    rows[:, ::13] = R + 3
    lf = _lf(rng, Lw, N)
    wide = torch.from_numpy(rng.normal(size=(N, (Lw + 2) * F)).astype(
        np.float32))
    djw = torch.from_numpy(rng.normal(size=(3, N, (Lw + 1) * Fj)).astype(
        np.float32))

    def on(dev):
        dj = djw.to(dev)[:, :, Fj:] if with_dj else None
        return (rows.to(dev), lf.to(dev), wide.to(dev)[:, F:F + Lw * F], dj)
    return on


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("Lw,N,F,window,with_dj", [
    (4, 196_608, 8, (0, None), True),      # training's density launch
    (4, 196_608, 8, (0, None), False),     # training's rgb launch
    (16, 1_000, 8, (0, None), True),
    (3, 1_001, 4, (1, 3), True),
    (5, 77, 2, (1, 2), True),
    (11, 20_000, 16, (0, 8), True),        # fused, direct levels
    (16, 1_000, 16, (0, 8), False)])
def test_k2_bwd_tiles_bitwise(cuda, bf16, Lw, N, F, window, with_dj):
    """Each cell on its own row: no two atomics meet, so the kernel must
    give the plain version's bits (strided cotangents, ragged tiles,
    jacobian windows, bf16 rounding per cell)."""
    rng = np.random.default_rng(12)
    jac_lo, jac_hi = window
    Fj = (F if jac_hi is None else jac_hi) - jac_lo
    R = Lw * N
    on = _k2b_case(rng, Lw, N, F, Fj, R, True, with_dj)
    W = 32 * F
    ref = k2.brick_reduce_bwd_plain(torch.zeros(R, W), *on("cpu"), F,
                                    jac_lo, jac_hi, bf16)
    args = on(cuda)
    assert not args[2].is_contiguous()
    n0 = build.LAUNCHES["ingp_brick_reduce_bwd"]
    out = k2.brick_reduce_bwd(torch.zeros((R, W), device=cuda), *args, F,
                              jac_lo, jac_hi, bf16)
    torch.cuda.synchronize()
    assert build.LAUNCHES["ingp_brick_reduce_bwd"] == n0 + 1
    assert float(ref.abs().max()) > 0
    assert torch.equal(out.cpu(), ref)


def _quiet(args, F, Fj):
    """Zero the cotangents of every 5th sample at one level (l = n/5 mod
    Lw) in place, through the column-slice views; returns the (Lw, N)
    mask of those cells."""
    rows, _, df, dj = args
    Lw, N = rows.shape
    n = torch.arange(0, N, 5)
    lv = (n // 5) % Lw
    df.unflatten(1, (Lw, F))[n.to(df.device), lv.to(df.device)] = 0.0
    if dj is not None:
        dj.unflatten(2, (Lw, Fj))[:, n.to(dj.device), lv.to(dj.device)] = 0.0
    mask = torch.zeros((Lw, N), dtype=torch.bool)
    mask[lv, n] = True
    return mask


def _new_launches(before):
    return {k: v - before.get(k, 0) for k, v in build.LAUNCHES.items()
            if v != before.get(k, 0)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("F,window,with_dj", [
    (2, (0, None), True), (4, (1, 3), True), (8, (0, None), True),
    (8, (0, None), False), (16, (0, 8), True), (16, (0, 8), False)])
def test_k2_bwd_and_pos_matches_plain(cuda, dtype, F, window, with_dj):
    """K2 backward's position-cotangent variant, one launch for the table
    gradient and dpos: the gradient within 1e-5 of the plain version's
    largest value (the atomics add in any order), dpos within 1e-5 of
    its largest value; exact zeros on cells with all-zero cotangents,
    cells marked -9 and rows outside the table. Lw = 9 (no divisor of
    32, a ragged last tile), column-slice cotangents, f32 and bf16
    storage, jacobian windows."""
    rng = np.random.default_rng(13)
    jac_lo, jac_hi = window
    Fj = (F if jac_hi is None else jac_hi) - jac_lo
    Lw, N, R, W = 9, 3001, 400, 32 * F
    on = _k2b_case(rng, Lw, N, F, Fj, R, False, with_dj)
    table = torch.from_numpy(rng.normal(size=(R, W)).astype(
        np.float32)).to(dtype)
    bf16 = dtype == torch.bfloat16
    cpu, dev = on("cpu"), on(cuda)
    quiet = _quiet(cpu, F, Fj)
    _quiet(dev, F, Fj)
    assert not dev[2].is_contiguous()
    ref_g = k2.brick_reduce_bwd_plain(torch.zeros(R, W), *cpu, F, jac_lo,
                                      jac_hi, bf16)
    ref_p = k2.brick_reduce_bwd_pos_plain(table, *cpu, F, jac_lo, jac_hi)
    before = dict(build.LAUNCHES)
    grad = torch.zeros((R, W), device=cuda)
    dpos = k2.brick_reduce_bwd_and_pos(grad, table.to(cuda), *dev, F,
                                       jac_lo, jac_hi, bf16)
    torch.cuda.synchronize()
    assert _new_launches(before) == {"ingp_brick_reduce_bwd_and_pos": 1}
    _close(grad, ref_g)
    scale = float(ref_p.abs().max())
    assert scale > 0
    assert float((dpos.cpu() - ref_p).abs().max()) <= 1e-5 * scale
    rows, lf = cpu[:2]
    for dead in (quiet, lf[0] < 0, rows >= R):
        assert dead.any() and not bool(dpos.cpu()[:, dead].any())


def test_k2_bwd_and_pos_refuses(cuda):
    """The variant reads bf16 storage exactly when it rounds the lane
    cotangents to bf16, of the gradient's shape: anything else raises
    and launches nothing."""
    rng = np.random.default_rng(15)
    args = _k2b_case(rng, 4, 300, 8, 8, 40, False, True)(cuda)
    grad = torch.zeros((40, 256), device=cuda)
    before = dict(build.LAUNCHES)
    for storage, bf16 in ((torch.zeros((40, 256), device=cuda), True),
                          (torch.zeros((40, 256), device=cuda,
                                       dtype=torch.bfloat16), False),
                          (torch.zeros((41, 256), device=cuda), False)):
        with pytest.raises(ValueError):
            k2.brick_reduce_bwd_and_pos(grad, storage, *args, 8, bf16=bf16)
    assert _new_launches(before) == {}


@pytest.mark.parametrize("with_dj", [True, False])
def test_k2_bwd_matches_old_body(cuda, with_dj):
    """The redesigned K2 backward against the body it replaced (the K2
    bwd split's `full`) at training's shape, rows of a density-sized
    table shared between cells, bf16: only the atomics' order differs."""
    from ingp_tpu_torch.probes import kernel_split as ps
    rng = np.random.default_rng(13)
    Lw, N, R = 4, 196_608, 207_295
    args = _k2b_case(rng, Lw, N, 8, 8, R, False, with_dj)(cuda)
    old = ps.split_k2b("full", torch.zeros((R, 256), device=cuda),
                       *(t if t is None else t.contiguous() for t in args),
                       bf16=True)
    new = k2.brick_reduce_bwd(torch.zeros((R, 256), device=cuda), *args, 8,
                              bf16=True)
    _close(new.cpu(), old.cpu())


def test_k2_bwd_needs_16_byte_rows(cuda):
    """The kernel adds each corner's lanes with 16-byte atomics: the
    wrapper refuses a gradient whose rows are not 16-byte aligned, and
    cotangents whose rows are not contiguous, and launches nothing."""
    rng = np.random.default_rng(14)
    rows, lf, df, dj = _k2b_case(rng, 4, 300, 8, 8, 40, False, True)(cuda)
    n0 = build.LAUNCHES["ingp_brick_reduce_bwd"]
    shifted = torch.zeros(40 * 256 + 1, device=cuda)[1:].view(40, 256)
    with pytest.raises(ValueError):
        k2.brick_reduce_bwd(shifted, rows, lf, df, dj, 8)
    with pytest.raises(ValueError):
        k2.brick_reduce_bwd(torch.zeros((40, 218), device=cuda), rows, lf,
                            df, dj, 8)
    column_major = torch.zeros((32, 300), device=cuda).T     # (300, 32)
    with pytest.raises(ValueError):
        k2.brick_reduce_bwd(torch.zeros((40, 256), device=cuda), rows, lf,
                            column_major, dj, 8)
    assert build.LAUNCHES["ingp_brick_reduce_bwd"] == n0


def _k3_bwd_case(rng, R, S, C):
    valid = torch.from_numpy(rng.random((R, S)) < 0.8)
    valid[0] = False
    sig = torch.from_numpy((10.0 ** rng.uniform(-2, 3, (R, S))).astype(
        np.float32))
    dt = torch.from_numpy(rng.uniform(0.002, 0.03, (R, S)).astype(
        np.float32))
    ts = torch.cumsum(dt, 1) + 0.3
    rgbs = torch.from_numpy(rng.uniform(0, 1, (3, R, S)).astype(np.float32))
    aux = torch.from_numpy(rng.normal(size=(C, R, S)).astype(np.float32))
    cts = [torch.from_numpy(rng.normal(size=s).astype(np.float32))
           for s in ((R, S), (R,), (R,), (R, 3), (R, C))]
    return [sig, dt, ts, valid], rgbs, aux, cts


@pytest.mark.parametrize("C", [0, 13])
@pytest.mark.parametrize("S", [24, 48, 64, 100, 333])
def test_k3_bwd_segments_match_plain(cuda, S, C):
    """Rays of one or more 32-sample segments (carried csum and scans),
    an all-invalid ray: the kernel within 1e-5 of the plain version's
    largest value, and dsigma exactly 0 on every sample that K3
    forward's own Ts excludes."""
    rng = np.random.default_rng(S + C)
    base, rgbs, aux, cts = _k3_bwd_case(rng, 999, S, C)
    ref = k3.composite_bwd_plain(*base, 1e-4, rgbs, aux, *cts)
    dev = [t.to(cuda) for t in base]
    n0 = build.LAUNCHES["ingp_composite_bwd"]
    out = k3.composite_bwd(*dev, 1e-4, rgbs.to(cuda), aux.to(cuda),
                           *(t.to(cuda) for t in cts))
    torch.cuda.synchronize()
    assert build.LAUNCHES["ingp_composite_bwd"] == n0 + 1
    for a, b in zip(out, ref):
        if b.numel():
            _close(a, b)
    Ts = k3.composite_fwd(*dev, 1e-4, with_Ts=True)["Ts"]
    excluded = ~(dev[3] & (Ts > 1e-4))
    assert bool(excluded.any()) and not bool(out[0][excluded].any())


def test_k3_bwd_matches_old_body(cuda):
    """The warp-per-ray K3 backward against the thread-per-ray body it
    replaced (the split's `k3 bwd full`) at training's (8192, 48), 13
    aux channels."""
    from ingp_tpu_torch.probes import kernel_split as ps
    rng = np.random.default_rng(15)
    base, rgbs, aux, cts = _k3_bwd_case(rng, 8192, 48, 13)
    args = [t.to(cuda) for t in base] + [1e-4, rgbs.to(cuda), aux.to(cuda)] \
        + [t.to(cuda) for t in cts]
    new = k3.composite_bwd(*args)
    old = ps.split_k3b("full", *args)
    for a, b in zip(new, old):
        _close(a.cpu(), b.cpu())


def test_k3_bwd_refuses_long_rays(cuda):
    """A ray's 9 floats per sample must fit the block's shared memory:
    S above BWD_MAX_S is refused before any launch."""
    rng = np.random.default_rng(16)
    S = k3.BWD_MAX_S + 1
    base, rgbs, aux, cts = _k3_bwd_case(rng, 2, S, 1)
    n0 = build.LAUNCHES["ingp_composite_bwd"]
    with pytest.raises(ValueError):
        k3.composite_bwd(*(t.to(cuda) for t in base), 1e-4, rgbs.to(cuda),
                         aux.to(cuda), *(t.to(cuda) for t in cts))
    assert build.LAUNCHES["ingp_composite_bwd"] == n0


# The redesigned K3 forward (a group of 16 lanes per ray, segments of 16
# samples, the same serial csum as the thread-per-ray body it replaced).

@pytest.mark.parametrize("C", [0, 13, 20])
@pytest.mark.parametrize("S", [1, 33, 48, 100, 1000])
def test_k3_fwd_segments_match_plain(cuda, S, C):
    """Rays of one or more 16-sample segments, S = 1000 above BWD_MAX_S
    (the forward stages one segment at a time), C = 20 beyond the 16 aux
    channels a pass keeps in registers (a second pass): one launch per
    call, count equal to the plain version's and every other output
    within 1e-5 of its largest value; ws, Ts and count bitwise equal to
    the old body (the split's `k3 fwd full`); without ts, no depth and
    the same ws, Ts and count."""
    from ingp_tpu_torch.probes import kernel_split as ps
    rng = np.random.default_rng(S + C + 40)
    (sig, dt, ts, valid), rgbs, aux, _ = _k3_bwd_case(rng, 999, S, C)
    aux = aux if C else None
    ref = k3.composite_plain(sig, dt, ts, valid, 1e-4, rgbs, aux, True)
    dev = [t.to(cuda) for t in (sig, dt, ts, valid)]
    rgbs_d = rgbs.to(cuda)
    aux_d = None if aux is None else aux.to(cuda)
    n0 = build.LAUNCHES["ingp_composite_fwd"]
    out = k3.composite_fwd(*dev, 1e-4, rgbs_d, aux_d, True)
    torch.cuda.synchronize()
    assert build.LAUNCHES["ingp_composite_fwd"] == n0 + 1
    assert set(out) == set(ref)
    assert torch.equal(out["count"].cpu(), ref["count"])
    for k in set(ref) - {"count"}:
        _close(out[k], ref[k])
    old = ps.split_k3f("full", *dev, 1e-4, rgbs_d, aux_d, True)
    no_ts = k3.composite_fwd(dev[0], dev[1], None, dev[3], 1e-4,
                             with_Ts=True)
    assert "depth" not in no_ts
    for k in ("ws", "Ts", "count"):
        assert torch.equal(out[k], old[k]), k
        assert torch.equal(no_ts[k], out[k]), k


def test_k3_fwd_matches_old_body(cuda):
    """At training's (8192, 48) with 13 aux channels and with Ts only
    (no ts, no rgb: the old body is handed a zero ts plane, as the step
    gave it before): ws, Ts and count bitwise equal to the thread-per-ray
    body the kernel replaced (the split's `k3 fwd full`), opacity, depth,
    rgb and aux within 1e-5 of its largest value; one launch per call."""
    from ingp_tpu_torch.probes import kernel_split as ps
    rng = np.random.default_rng(17)
    (sig, dt, ts, valid), rgbs, aux, _ = _k3_bwd_case(rng, 8192, 48, 13)
    sig, dt, ts, valid, rgbs, aux = (t.to(cuda) for t in (
        sig, dt, ts, valid, rgbs, aux))
    for new_args, old_args in (
            ((sig, dt, ts, valid, 1e-4, rgbs, aux, True),) * 2,
            ((sig, dt, None, valid, 1e-4, None, None, True),
             (sig, dt, torch.zeros_like(ts), valid, 1e-4, None, None,
              True))):
        n0 = build.LAUNCHES["ingp_composite_fwd"]
        new = k3.composite_fwd(*new_args)
        assert build.LAUNCHES["ingp_composite_fwd"] == n0 + 1
        old = ps.split_k3f("full", *old_args)
        for k in ("ws", "Ts", "count"):
            assert torch.equal(new[k], old[k]), k
        for k in set(new) - {"ws", "Ts", "count"}:
            _close(new[k].cpu(), old[k].cpu())
