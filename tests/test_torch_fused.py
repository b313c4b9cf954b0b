"""Port parity of the fused encoder (`encoder="fused"`: one brick table
whose lattice points hold the density features and then the rgb
features, 16 per point at the bench's 8 + 8) against ingp_tpu on CPU:

- the plain K1 and K2 at F = 16 with the fused jacobian window [0, 8),
  forward and backward, against the Pallas kernels run with
  interpret=True (K2's Pallas form has no window: its full jacobian and
  its vjp with a zero cotangent outside the window stand in);
- the per-sample brick encoder (stream dedup off) at F = 16;
- `fused_brick_cfg`, `ngp_init` (the one `grid_table`), the numpy
  round trip of the parameters, and `ngp_grad_cm`'s one pass (density
  features, density jacobian and rgb features) on the sorted and the
  unsorted stream and per sample;
- one f32 training step against JAX's `train_step`, and a pose-
  refinement step on the port;
- `train.main`, then the mesh CLI of the port and of JAX on one small
  fused checkpoint, and the render CLI.

Tolerances: the kernels and encoders at test_torch_grad.py's f32
bounds (rtol 1e-5 plus 1e-6 of the largest |value|; the jacobian, which
carries the level scale, 1e-5 of its largest |value|; bf16 tables at
close_bf16's one bf16 step; whole encoders against JAX's XLA dot form
of the reduce at 1e-5 of the largest |value|, test_torch_grad.py's
ENC_ATOL_FRAC; the model functions at rtol 1e-5 plus 1e-4 of the
largest |value|, MODEL_ATOL_FRAC); the step at test_torch_train.py's
bounds (loss rtol
1e-5, each gradient leaf 1e-4 of its largest |value| [grid_table
1.4e-5]), but norm_net's at 1e-3, chip_smoke.py's card-vs-CPU bound for
it [7.0e-4]: norm_net reaches the loss only through the Ref-NeRF term
of the normalised density gradient (test_torch_train.py's note), and
its error here is the brick step's in absolute terms (4.4e-11 against
3.8e-11, both per-sample and on the stream) while the leaf's largest
value is 6.4 times smaller (6.3e-8 against 4.0e-7); the mesh at
test_torch_mesh.py's."""
import os
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ingp_tpu import extract_mesh_cli as jmesh_cli
from ingp_tpu.models import ngp as jngp
from ingp_tpu.ops import brickgrid as jb
from ingp_tpu.ops.pallas.brickreduce_pallas import fused_brick_reduce
from ingp_tpu.ops.pallas.rayreduce_pallas import fused_ray_reduce as j_frr
from ingp_tpu.utils import ckpt as jckpt

from ingp_tpu_torch import extract_mesh_cli, render_cli
from ingp_tpu_torch import train as train_cli
from ingp_tpu_torch.core import prng
from ingp_tpu_torch.kernels import brickreduce as k2
from ingp_tpu_torch.kernels import rayreduce as k1
from ingp_tpu_torch.models import ngp as tngp
from ingp_tpu_torch.ops import brickgrid as tb
from ingp_tpu_torch.training import trainer as tt
from ingp_tpu_torch.utils import ckpt as tckpt
from tests._torch_threads import one_torch_thread  # noqa: F401
from tests.test_torch_grad import (_k1_case, _k1_jax_grad, _k1_port_grad,
                                   _k2_case, _k2_port_grad, _scatter_rows,
                                   ENC_ATOL_FRAC, close_bf16, close_f32)
from tests.test_torch_stream import _k1_inputs, _jax_grouped
from tests.test_torch_train_variants import check_step, setup

F, FD = 16, 8            # fused features per point, the density window
# the model functions against JAX's (its per-sample levels through XLA's
# CPU dot form of the reduce), as a fraction of each output's largest
# |value|: on this stream the brick encoder's outputs stray as far (rgb
# features 8.5e-5, density gradient 5.5e-5) as the fused one's (7.0e-5,
# 3.5e-5), per sample and on the stream alike
MODEL_ATOL_FRAC = 1e-4


def T(a):
    return torch.as_tensor(np.array(a))


def N(a):
    if torch.is_tensor(a):
        a = a.detach()
    return np.asarray(a, dtype=np.float32)


def close_enc(out, ref):
    """A whole encoder against JAX's XLA dot form of the reduce, which
    strays up to 6.7e-6 of the largest |value| from float64
    (test_torch_grad.py ENC_ATOL_FRAC)."""
    close_f32(out, ref, ENC_ATOL_FRAC)


def close_jac(out, ref):
    """The jacobian carries the level scale: 1e-5 of its largest
    |value| (test_torch_stream.py's bound)."""
    np.testing.assert_allclose(out, ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())


# ------------------------------------------------------------- kernels

@pytest.mark.parametrize("bf16", [False, True])
def test_k1_f16_window_matches_pallas(bf16):
    """K1 forward and backward at F = 16, jacobian window [0, 8)."""
    B, U, K = 8, 32, 128
    table, urows, uid, lf = _k1_inputs(2, B, U, K, 32 * F, F, bf16)
    jg = jnp.asarray(table[urows], jnp.bfloat16 if bf16 else jnp.float32)
    fj, jj = j_frr(jg, uid, lf, F, True, 0, FD, True)
    tt_ = T(table).to(torch.bfloat16) if bf16 else T(table)
    ft, jt = k1.fused_ray_reduce(tt_, T(urows), T(uid), T(lf), F, True, 0,
                                 FD)
    assert jt.shape == (3 * FD, B, K)
    close_f32(N(ft), N(fj))
    close_jac(N(jt), N(jj))
    assert (N(ft)[:, :, ::9] == 0).all()
    table, urows, uid, lf, df, dj = _k1_case(1, B, 48, 256, F, bf16=bf16)
    ref = _k1_jax_grad(table, urows, uid, lf, df, dj, F, True, 0, FD, bf16)
    out = _k1_port_grad(table, urows, uid, lf, df, dj, F, 0, FD, bf16)
    (close_bf16 if bf16 else close_f32)(out, ref)


@pytest.mark.parametrize("bf16", [False, True])
def test_k2_f16_window_matches_pallas(bf16):
    """K2 forward and backward at F = 16, window [0, 8): the Pallas
    kernel computes the full jacobian; its window rows stand in, and
    its vjp takes a cotangent that is zero outside the window."""
    Lw, n = 2, 512
    table, rows, lf, df, dj = _k2_case(4, Lw, n, F, 300, bf16)
    g = jnp.asarray(table, jnp.bfloat16 if bf16 else jnp.float32
                    )[rows.reshape(-1)]
    fj, jj = fused_brick_reduce(g, lf.reshape(8, -1), F, True)
    tt_ = T(table).to(torch.bfloat16) if bf16 else T(table)
    ft, jt = k2.brick_reduce(tt_, T(rows), T(lf), F, True, 0, FD)
    fj = N(fj).reshape(F, Lw, n).transpose(2, 1, 0).reshape(n, Lw * F)
    jj = N(jj).reshape(3, F, Lw, n)[:, :FD].transpose(0, 3, 2, 1
                                                      ).reshape(3, n, -1)
    close_f32(N(ft), fj)
    close_jac(N(jt), jj)
    # backward: the window's cotangent, zero on features FD..F-1
    djw = dj.reshape(3, n, Lw, F)[..., :FD].reshape(3, n, Lw * FD)
    _, vjp = jax.vjp(lambda g: fused_brick_reduce(g, lf.reshape(8, -1), F,
                                                  True), g)
    dfj = df.reshape(n, Lw, F).transpose(2, 1, 0).reshape(F, -1)
    djj = np.zeros((3, F, Lw, n), np.float32)
    djj[:, :FD] = djw.reshape(3, n, Lw, FD).transpose(0, 3, 2, 1)
    (dg,) = vjp((jnp.asarray(dfj), jnp.asarray(djj.reshape(3 * F, -1))))
    ref = _scatter_rows(rows, dg, table.shape[0])
    out = _k2_port_grad(table, rows, lf, df, djw, F, 0, FD, bf16)
    (close_bf16 if bf16 else close_f32)(out, ref)


def test_k2_f16_position_cotangent_matches_ad():
    """Row 4b at F = 16 with the window: the position cotangent against
    JAX AD of reduce_feats_jac through frac."""
    Lw, n = 3, 160
    table, rows, lf, df, dj = _k2_case(6, Lw, n, F, 97)
    cfg = jb.BrickGridConfig(n_levels=Lw, n_features=F, log2_bricks=8)
    lf[6] = np.asarray(cfg.scales, np.float32)[:, None]
    g = table[rows.reshape(-1)]
    djw = dj.reshape(3, n, Lw, F)[..., :FD].reshape(3, n, -1)
    local = lf[0:3]
    _, vjp = jax.vjp(lambda fr: jb.reduce_feats_jac(cfg, g, local, fr, n, 0,
                                                    FD), lf[3:6])
    ref = N(vjp((jnp.asarray(df), jnp.asarray(djw)))[0])
    out = k2.brick_reduce_bwd_pos_plain(T(table), T(rows), T(lf), T(df),
                                        T(djw), F, 0, FD)
    ok = (lf[0:3] >= 0).all(0)
    close_f32(N(out)[:, ok], ref[:, ok])
    assert not N(out)[:, ~ok].any()


def test_per_sample_brick_encode_f16_matches():
    """ops/brickgrid at F = 16 with the fused window, against JAX's."""
    args = dict(n_levels=4, n_features=F, log2_bricks=9, base_resolution=16,
                per_level_scale=1.5)
    jc, tc = jb.BrickGridConfig(**args), tb.BrickGridConfig(**args)
    assert tc.row_width == jc.row_width == 512
    table = N(jb.brickgrid_init(jax.random.PRNGKey(3), jc)) * 1e3
    x = np.random.default_rng(4).uniform(0, 1, (700, 3)).astype(np.float32)
    fj, jj = jb.brickgrid_encode_grad(jc, table, x, chunk=512, jac_lo=0,
                                      jac_hi=FD)
    ft, jt = tb.brickgrid_encode_grad(tc, T(table), T(x), chunk=512,
                                      jac_lo=0, jac_hi=FD)
    close_enc(N(ft), N(fj))
    close_jac(N(jt), N(jj))
    np.testing.assert_array_equal(
        N(tb.brickgrid_encode(tc, T(table), T(x), chunk=512)), N(ft))


# --------------------------------------------------------------- model

def small_cfg(**kw):
    base = dict(density_L=4, rgb_L=4, density_log2T=12, rgb_log2T=12,
                grid_size=32, encoder="fused", stream_dedup=True,
                encode_chunk=2048)
    base.update(kw)
    return base


def test_fused_config_init_and_layout():
    kw = small_cfg()
    jc, tc = jngp.NGPConfig(**kw), tngp.NGPConfig(**kw)
    assert dataclasses_equal(tc.fused_brick_cfg, jc.fused_brick_cfg)
    assert tc.fused_brick_cfg.n_features == F
    with pytest.raises(AssertionError, match="density_L == rgb_L"):
        tngp.NGPConfig(**small_cfg(density_L=2)).fused_brick_cfg
    mine = tngp.ngp_init(tc, prng.prng_key(0))
    ref = jngp.ngp_init(jax.random.PRNGKey(0), jc)
    assert set(mine) == set(ref) and "density_table" not in mine
    back = tngp.params_to_numpy(mine, tc)
    for (pa, a), (pb, b) in zip(tt.tree_leaves(back),
                                tt.tree_leaves(jax.tree.map(N, ref))):
        assert pa == pb
        np.testing.assert_array_equal(a, b)
    again = tngp.params_from_numpy(back, cfg=tc)
    assert torch.equal(again["grid_table"], mine["grid_table"])


def dataclasses_equal(a, b):
    import dataclasses
    return dataclasses.asdict(a) == dataclasses.asdict(b)


@pytest.mark.parametrize("stream", ["sorted", True, False])
def test_fused_grad_cm_matches(monkeypatch, stream):
    """ngp_grad_cm's one fused pass: sigmas, rgb features and the
    density gradient, on a sorted stream with the head class, an
    unsorted one, and per sample; ngp_sigma and ngp_rgb_feat too."""
    kw = small_cfg(stream_head_frac=0.5, stream_seg_head=20,
                   stream_dedup=stream is not False)
    jc, tc = jngp.NGPConfig(**kw), tngp.NGPConfig(**kw)
    p = jax.tree.map(lambda a: np.array(a, np.float32),
                     jngp.ngp_init(jax.random.PRNGKey(1), jc))
    p["grid_table"] *= 1e3
    tp = tngp.params_from_numpy(p, cfg=tc)
    from tests.test_torch_stream import ray_stream
    x = (ray_stream(3, n_rays=300) - 0.5) * 0.9
    _jax_grouped(monkeypatch)
    got = tngp.ngp_grad_cm(tc, tp, T(x), stream=stream)
    ref = jngp.ngp_grad_cm(jc, p, x, stream=stream)
    for a, b in zip(got, ref):
        close_f32(N(a), N(b), MODEL_ATOL_FRAC)
    close_f32(N(tngp.ngp_sigma_cm(tc, tp, T(x), stream=stream)),
              N(jngp.ngp_sigma_cm(jc, p, x, stream=stream)), MODEL_ATOL_FRAC)
    close_f32(N(tngp.ngp_rgb_feat(tc, tp, T(x.T))),
              N(jngp.ngp_rgb_feat(jc, p, x.T)), MODEL_ATOL_FRAC)


# ---------------------------------------------------------------- step

def test_fused_train_step_matches():
    """encoder="fused" on bench.py's stream (sorted, two encode chunks)
    with the sorted head class: one f32 step against JAX's."""
    check_step("fused, head class", norm_frac=1e-3)


def test_fused_pose_refinement_step_runs():
    """--optimize_ext on the fused model: the pose corrections take a
    gradient through the per-sample levels' position cotangent (K2's
    row 4b at F = 16) and move."""
    h, _, params, _, tr, grid, batch = setup("fused, per sample, ext")
    psys = tt.NeRFSystem(h, tr, device="cpu", params=params)
    psys.grid = grid
    calls = []
    real = k2.brick_reduce_bwd_and_pos

    def spy(*a, **k):
        calls.append(a[6] if len(a) > 6 else k["F"])
        return real(*a, **k)
    k2.brick_reduce_bwd_and_pos = spy
    try:
        aux, grads = psys.loss_and_grads(batch, T(batch["noise"]))
    finally:
        k2.brick_reduce_bwd_and_pos = real
    assert calls and set(calls) == {F}
    assert all(float(g.abs().max()) > 0 for g in grads["ext"].values())


# ------------------------------------------------------------------ CLIs

TINY_FUSED = ["--dataset_name", "synthetic", "--num_epochs", "1",
              "--normal_epochs", "0", "--steps_per_epoch", "2",
              "--batch_size", "256", "--capacity", "32",
              "--march_iters", "128", "--samples_per_ray", "8",
              "--grid_size", "32", "--encoder", "fused", "--stream_dedup",
              "--density_L", "4", "--rgb_L", "4", "--density_log2T", "12",
              "--rgb_log2T", "12", "--chunk_size", "1024",
              "--downsample", "0.25", "--exp_name", "fused"]


def test_fused_clis(tmp_path, monkeypatch, capsys):
    """train.main on the fused encoder, then on its checkpoint (grid
    table scaled so that the field has structure) the port's and the
    JAX package's mesh CLIs (the same surface, test_torch_mesh.py's
    bounds) and the port's render CLI."""
    from scipy.spatial import cKDTree
    from tests.test_torch_mesh import RES, _read_ply
    monkeypatch.chdir(tmp_path)
    m = train_cli.main(TINY_FUSED + ["--no_save_test"], device="cpu")
    assert np.isfinite(m["psnr"])
    last = tmp_path / "ckpts" / "synthetic" / "fused" / "last"
    state = tckpt.load_ckpt(str(last))
    assert "grid_table" in state["params"]["model"]
    state["params"]["model"]["grid_table"] *= 3e4
    state["grid"]["bitfield"][:] = -1
    del state["grid"]["block_table"]
    tckpt.save_ckpt(str(tmp_path / "port_ckpt"), state)
    jstate = {k: v for k, v in state.items() if k != "opt_state"}
    jstate = jax.tree.map(lambda t: t.numpy() if torch.is_tensor(t) else t,
                          jstate)
    jstate["grid"]["bitfield"] = jstate["grid"]["bitfield"].view(np.uint32)
    jckpt.save_ckpt(str(tmp_path / "jax_ckpt"), jstate)
    # the threshold: the loaded field's median density on the probe grid
    from ingp_tpu_torch.render import mesh as tmesh
    from ingp_tpu_torch.training.config import get_opts
    h = get_opts(TINY_FUSED)
    sys_ = tt.NeRFSystem(h, device="cpu")
    sys_.load(str(tmp_path / "port_ckpt"))
    cfg = sys_.model_cfg
    vol, _ = tmesh.probe_density(lambda p, x: tngp.ngp_sigma(cfg, p, x),
                                 sys_.params["model"], 0.5, (16, 12, 20),
                                 2 ** 17, torch.device("cpu"))
    flags = RES + ["--sigma_threshold", str(float(vol.median()))]
    outs = {}
    for side, main in (("port", extract_mesh_cli.main),
                       ("jax", jmesh_cli.main)):
        cwd = tmp_path / side
        cwd.mkdir()
        monkeypatch.chdir(cwd)
        argv = TINY_FUSED + ["--exp_name", "cli", "--ckpt_load",
                             str(tmp_path / f"{side}_ckpt")] + flags
        if side == "port":
            monkeypatch.setattr(sys, "argv", ["cli"] + argv)
            main(device="cpu")
        else:
            main(argv)
        outs[side] = _read_ply(cwd / "results" / "synthetic" / "cli" /
                               "mesh.ply")
    (_, tv, tf), (_, jv, jf) = outs["port"], outs["jax"]
    assert len(jf) > 1000
    assert abs(len(tf) - len(jf)) <= 5e-3 * len(jf)
    assert cKDTree(jv).query(tv)[0].max() <= 1e-5
    assert cKDTree(tv).query(jv)[0].max() <= 1e-5
    monkeypatch.chdir(tmp_path)
    out = render_cli.main(TINY_FUSED + ["--render_rgb"], device="cpu")
    assert sorted(os.listdir(out)) and all(
        n.endswith(".png") for n in os.listdir(out))
