"""Port parity of the training slice: sample_batch, the losses and
metrics, one whole training step, the optimiser and a 3-step trajectory
of ingp_tpu_torch against ingp_tpu on CPU (the training render and the
occupancy grid are held in test_torch_train_render.py, the bf16
trajectory in test_torch_train_bf16.py; split so that each file runs
in well under a minute).

Both sides start from the same numpy parameters (the JAX system's,
tables scaled up so that the encoders' features matter), the same grid
(marked from the scene's spheres), the same batches and the same ray
jitter (`batch["noise"]`). The JAX grouped stream path runs its Pallas
kernels through the interpreter (INGP_STREAM_GROUPED_INTERPRET=1). The
encode chunk (2048 samples) is below the step's 4096-sample budget, so
the stream is striped over two chunks.

Tolerances, f32 tables and compute (measured values in brackets):
- the loss to rtol 1e-5 [equal to the last bit];
- every gradient leaf to 1e-4 of the leaf's largest |value| [4e-5],
  except norm_net's to 3e-4 [1.02e-4]: norm_net reaches the loss only
  through the Ref-NeRF term (nraw - npred)^2, so it inherits the error
  of normal_raw, the normalised density gradient, whose JAX side goes
  through XLA's CPU dot form of the reduce (6.7e-6 of the largest value
  from float64 where the port's plain backward is within 6.5e-8,
  test_torch_grad.py) and is amplified by the normalisation;
- the optimiser alone (clip + Adam + cosine LR on the same gradients)
  to 1e-6 of each leaf's largest |value|;
- the update of a whole step (parameters after minus before) to 1e-4 of
  the leaf's largest |update| [3.6e-5], on the entries whose Adam
  denominator sqrt(v_hat) is above 1e-7, ten times Adam's epsilon
  (ADAM_FLOOR; 4,244 entries here, the MLPs' and the tables' largest
  gradients): the first update lr * g / (|g| + 1e-8) turns a gradient
  difference d on an entry with |g| near 1e-8 into an update difference
  of up to lr * d / (4e-8), so below the floor the gradients'
  1e-5-level differences reach the update amplified (the optimiser
  test above holds that arithmetic on every entry);
- the parameters after a whole step to 1e-3 of the leaf's largest
  |value| [1.9e-4], every entry;
- the 3-step trajectory: each step's loss to rtol 1e-5 [8.3e-7], the
  update of the three steps to 1e-3 of the largest |update| on the
  entries above the floor at every step [3.4e-4: steps 2 and 3 start
  from the slightly different parameters of the steps before], the
  parameters to 1e-3 [1.8e-4].
The bf16 tolerances are in test_torch_train_bf16.py.
"""
import contextlib
import os
from types import SimpleNamespace

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ingp_tpu.data.synthetic import SyntheticDataset as JData
from ingp_tpu.grid import occupancy as jocc
from ingp_tpu.models import ngp as jngp
from ingp_tpu.models import rendering as jr
from ingp_tpu.ops import pack as jp
from ingp_tpu.ops import streambrick as js
from ingp_tpu.ops.march import build_block_table
from ingp_tpu.training import losses as jl
from ingp_tpu.training import metrics as jm
from ingp_tpu.training import trainer as jt

from ingp_tpu_torch.data.synthetic import SyntheticDataset, \
    sphere_density_grid
from ingp_tpu_torch.grid import occupancy as tocc
from ingp_tpu_torch.grid.occupancy import grid_from_density
from ingp_tpu_torch.models import ngp as tngp
from ingp_tpu_torch.models import rendering as tr
from ingp_tpu_torch.training import losses as tl
from ingp_tpu_torch.training import metrics as tm
from ingp_tpu_torch.training import trainer as tt
from tests._torch_threads import one_torch_thread  # noqa: F401

R_BATCH = 256


def T(a):
    return torch.as_tensor(np.array(a))


def N(a):
    if torch.is_tensor(a):
        a = a.detach()
    return np.asarray(a, dtype=np.float32)


def hparams(precision="f32", **kw):
    """bench.py's training configuration at a small size."""
    cd = "float32" if precision == "f32" else "bfloat16"
    h = dict(dataset_name="synthetic", root_dir="", split="train",
             downsample=1.0, scale=0.5, use_skybox=False, use_exposure=False,
             embed_a=False, embed_a_len=4, embed_msk=False, num_classes=7,
             batch_size=R_BATCH, ray_sampling_strategy="all_images",
             num_epochs=20, normal_epochs=0, steps_per_epoch=1000, lr=1e-2,
             density_threshold=1e-2, depth_mono=False, normal_mono=False,
             normal_ref=True, optimize_ext=False, random_bg=False,
             render_semantic=False, chunk_size=2048, seed=0, ckpt_load=None,
             compute_dtype=cd, table_dtype=cd, capacity=48,
             march_iters=256, samples_per_ray=16, encoder="brick",
             encode_chunk=2048, stream_dedup=True, stream_tile=256,
             stream_seg=4, stream_slack=1.5, stream_direct_frac=0.7,
             stream_sort=True, stream_head_frac=0.0, encode_remat=False,
             density_L=4, rgb_L=4,
             density_log2T=12, rgb_log2T=12, grid_size=32)
    h.update(kw)
    return SimpleNamespace(**h)


@contextlib.contextmanager
def jax_grouped():
    """The JAX grouped stream path on CPU through the Pallas
    interpreter; jitted encoders re-trace under it."""
    old = {k: os.environ.get(k) for k in ("INGP_STREAM_GROUPED",
                                          "INGP_STREAM_GROUPED_INTERPRET")}
    os.environ["INGP_STREAM_GROUPED"] = "1"
    os.environ["INGP_STREAM_GROUPED_INTERPRET"] = "1"
    caches = (js.streambrick_encode, js.streambrick_encode_grad,
              jr.render_rays)
    for f in caches:
        f.clear_cache()
    try:
        yield
    finally:
        for f in caches:
            f.clear_cache()
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


class Pair:
    """A JAX system and a port system with the same parameters and grid."""

    def __init__(self, precision):
        h = hparams(precision)
        self.h = h
        jtr = JData(split="train", img_size=24, n_train=4)
        jte = JData(split="test", img_size=24, n_test=1)
        self.jsys = jt.NeRFSystem(h, jtr, jte)
        params = jax.tree.map(lambda a: np.array(a, np.float32),
                              self.jsys.params)
        params["model"]["density_table"] *= 1e4
        params["model"]["rgb_table"] *= 1e3
        self.params = params
        cfg = self.jsys.model_cfg
        dg = sphere_density_grid(cfg.grid_size, cfg.cascades, cfg.scale)
        self.bits = jp.packbits_u32(dg.reshape(-1), 0.5)
        self.table = build_block_table(self.bits, cfg.grid_size,
                                       cfg.cascades)
        self.tr = SyntheticDataset(split="train", img_size=24, n_train=4)
        te = SyntheticDataset(split="test", img_size=24, n_test=1)
        self.psys = tt.NeRFSystem(h, self.tr, te, device="cpu",
                                  params=params)
        self.psys.grid = grid_from_density(self.psys.grid, T(dg), 0.5,
                                           cfg.grid_size, cfg.cascades)
        rng = np.random.default_rng(0)
        self.batches = []
        for _ in range(3):
            b = self.tr.sample_batch(rng, R_BATCH)
            b["noise"] = rng.random(R_BATCH, dtype=np.float32)
            self.batches.append(b)

    def jax_steps(self, n):
        """(losses, params, opt_states) of n JAX train_steps: the loss of
        each step, the params after the n-th, the optimiser state after
        each. The three steps run once and are kept."""
        if not hasattr(self, "_jax"):
            j = self.jsys
            params = jax.tree.map(jnp.asarray, self.params)
            opt_state = j.tx.init(params)
            step = jnp.int32(0)
            losses, states, trail = [], [], []
            with jax_grouped():
                for b in self.batches:
                    batch = {k: jnp.asarray(v) for k, v in b.items()
                             if k in j.BATCH_KEYS}
                    params, opt_state, step, aux = j.train_step(
                        params, opt_state, self.bits, self.table,
                        j.directions, j.poses, batch, step, j._base_key)
                    losses.append(float(aux["loss"]))
                    # copied: the next step donates the state's buffers
                    states.append(jax.tree.map(N, opt_state))
                    trail.append(jax.tree.map(N, params))
            self._jax = losses, trail, states
        losses, trail, states = self._jax
        return losses[:n], trail[n - 1], states[:n]


_PAIRS = {}


def pair(precision):
    if precision not in _PAIRS:
        _PAIRS[precision] = Pair(precision)
    return _PAIRS[precision]


def _adam_moments(opt_state):
    """ScaleByAdamState (mu, nu) of an optax chain state."""
    for s in jax.tree_util.tree_leaves(
            opt_state, is_leaf=lambda x: hasattr(x, "mu")):
        if hasattr(s, "mu"):
            return s.mu, s.nu
    raise AssertionError("no Adam state")


def _leaf_close(a, b, frac, what):
    for (path, x), (_, y) in zip(tt.tree_leaves(a), tt.tree_leaves(b)):
        x, y = N(x), N(y)
        scale = np.abs(y).max()
        err = np.abs(x - y).max()
        assert err <= frac * scale, (what, path, err, scale)


# Adam's update is lr * m_hat / (sqrt(v_hat) + 1e-8): where sqrt(v_hat)
# comes near the epsilon, a gradient difference d moves the update by up
# to lr * d / 1e-8. The updates are compared where the denominator stayed
# above ten epsilons at every step.
ADAM_FLOOR = 1e-7


def _update_close(p0, p_port, p_jax, states_j, frac, what):
    """The update p_port - p0 against p_jax - p0 on the entries whose
    Adam denominator sqrt(v_hat) (from JAX's state after each step)
    stayed above ADAM_FLOOR, to frac of the largest |JAX update| there.
    Returns the worst error fraction and the number of entries held."""
    floors = None
    for t, st in enumerate(states_j):
        d = jax.tree.map(lambda v: np.sqrt(N(v) / (1 - 0.999 ** (t + 1))),
                         _adam_moments(st)[1])
        floors = d if floors is None else jax.tree.map(np.minimum, floors,
                                                       d)
    worst, held = 0.0, 0
    for (path, a0), (_, a), (_, b), (_, f) in zip(
            tt.tree_leaves(p0), tt.tree_leaves(p_port),
            tt.tree_leaves(p_jax), tt.tree_leaves(floors)):
        m = N(f) > ADAM_FLOOR
        if not m.any():
            continue
        u_port, u_jax = (N(a) - N(a0))[m], (N(b) - N(a0))[m]
        scale = np.abs(u_jax).max()
        err = np.abs(u_port - u_jax).max()
        assert err <= frac * scale, (what, path, err, scale)
        worst, held = max(worst, err / scale), held + int(m.sum())
    return worst, held


# ------------------------------------------------------------------ data

def test_sample_batch_matches():
    jd = JData(split="train", img_size=24, n_train=4)
    td = SyntheticDataset(split="train", img_size=24, n_train=4)
    for strategy in ("all_images", "same_image"):
        bj = jd.sample_batch(np.random.default_rng(3), 300, strategy)
        bt = td.sample_batch(np.random.default_rng(3), 300, strategy)
        assert set(bj) == set(bt)
        for k in bj:
            np.testing.assert_array_equal(bt[k], bj[k], err_msg=k)
            assert bt[k].dtype == bj[k].dtype, k


# ------------------------------------------------------- losses, metrics

def _results(seed, R=64, S=20):
    rng = np.random.default_rng(seed)
    sem = rng.uniform(0, 1, (R, 7)).astype(np.float32)
    return {
        "rgb": rng.uniform(0, 1, (R, 3)).astype(np.float32),
        "opacity": rng.uniform(0, 1, R).astype(np.float32),
        "depth": rng.uniform(0.2, 2, R).astype(np.float32),
        "distortion": rng.uniform(0, 1e-2, R).astype(np.float32),
        "Rp": rng.uniform(0, 1, (R, 3)).astype(np.float32),
        "Ro": rng.uniform(0, 1, R).astype(np.float32),
        "normal_pred": rng.normal(size=(R, 3)).astype(np.float32),
        "semantic": sem / sem.sum(-1, keepdims=True),
    }, {
        "rgb": rng.uniform(0, 1, (R, 3)).astype(np.float32),
        "label": np.where(rng.random(R) < 0.2, 256,
                          rng.integers(0, 7, R)).astype(np.int64),
        "normal": rng.normal(size=(R, 3)).astype(np.float32),
    }


@pytest.mark.parametrize("extra", [{}, dict(normal_mono=True,
                                            semantic=True)])
def test_losses_match(extra):
    res, tgt = _results(1)
    cfg_j = jl.LossConfig(normal_ref=True, **extra)
    cfg_t = tl.LossConfig(normal_ref=True, **extra)
    dj = jl.compute_losses(cfg_j, res, tgt, step=5)
    dt = tl.compute_losses(cfg_t, {k: T(v) for k, v in res.items()},
                           {k: T(v) for k, v in tgt.items()}, step=5)
    assert set(dt) == set(dj)
    for k in dj:
        np.testing.assert_allclose(N(dt[k]), N(dj[k]), rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    np.testing.assert_allclose(float(tl.total_loss(dt)),
                               float(jl.total_loss(dj)), rtol=1e-6)
    assert tl.annealing_weight(cfg_t, 3000) == pytest.approx(
        float(jl.annealing_weight(cfg_j, 3000)), rel=1e-6)


def test_metrics_match():
    rng = np.random.default_rng(2)
    a = rng.uniform(0, 1, (24, 20, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.05, a.shape), 0, 1).astype(np.float32)
    for ft, fj in ((tm.mse, jm.mse), (tm.psnr, jm.psnr),
                   (tm.ssim, jm.ssim)):
        np.testing.assert_allclose(float(ft(T(a), T(b))), float(fj(a, b)),
                                   rtol=1e-5)


def test_loss_config_and_lr_schedule_match():
    h = hparams()
    assert tt.loss_config_from_hparams(h).__dict__ == \
        jt.loss_config_from_hparams(h).__dict__
    import optax
    sched = optax.cosine_decay_schedule(1e-2, 20000, alpha=1.0 / 30)
    for t in (0, 1, 17, 9999, 20000, 25000):
        assert tt.cosine_lr(1e-2, 20000, t) == pytest.approx(
            float(sched(t)), rel=1e-6)


# ----------------------------------------------------- render and step

def test_train_step_matches():
    """Loss, every clipped gradient leaf (from the JAX Adam state after
    one step: mu = (1 - b1) g), the Adam moments, the update that clip +
    Adam + cosine LR make, and the parameters after it."""
    p = pair("f32")
    losses_j, params_j, (opt_j,) = p.jax_steps(1)
    mu_j, nu_j = _adam_moments(opt_j)
    psys = tt.NeRFSystem(p.h, p.tr, device="cpu", params=p.params)
    psys.grid = p.psys.grid
    b = p.batches[0]
    aux, grads = psys.loss_and_grads(b, T(b["noise"]))
    loss = float(aux["loss"])
    np.testing.assert_allclose(loss, losses_j[0], rtol=1e-5)
    tt.clip_by_global_norm([g for _, g in tt.tree_leaves(grads)])
    g_j = jax.tree.map(lambda m: N(m) / np.float32(1 - 0.9), mu_j)
    for name in grads["model"]:
        frac = 3e-4 if name == "norm_net" else 1e-4
        _leaf_close(grads["model"][name], g_j["model"][name], frac, name)
    assert not N(grads["embedding_a"]).any()
    p0 = psys.params_to_numpy()
    aux = psys.train_step(b)
    assert float(aux["loss"]) == pytest.approx(loss, rel=1e-6)
    st = psys.adam_state_to_numpy()
    assert st["count"] == 1
    _leaf_close(st["mu"]["model"], N_tree(mu_j)["model"], 3e-4, "mu")
    _leaf_close(st["nu"]["model"], N_tree(nu_j)["model"], 6e-4, "nu")
    _, held = _update_close(p0, psys.params_to_numpy(), params_j, [opt_j],
                            1e-4, "update")
    assert held > 1000
    _leaf_close(psys.params_to_numpy(), params_j, 1e-3, "param")


def test_optimizer_matches_optax():
    """clip_by_global_norm(50) -> Adam(eps 1e-8) at the cosine LR, on
    the same gradients, for an unclipped and a clipped step at a late
    count."""
    import optax
    p = pair("f32")
    rng = np.random.default_rng(4)
    params = jax.tree.map(N, p.params)
    for gscale, count in ((1e-3, 0), (10.0, 12345)):
        grads = jax.tree.map(lambda a: (rng.normal(size=a.shape) * gscale
                                        ).astype(np.float32), params)
        tx = p.jsys.tx
        st = tx.init(jax.tree.map(jnp.asarray, params))
        mu, nu = _adam_moments(st)
        mu = jax.tree.map(lambda a: N(a) + 1e-4, mu)
        nu = jax.tree.map(lambda a: N(a) + 1e-6, nu)
        st = _with_moments(st, mu, nu, count)
        upd, _ = jax.jit(tx.update)(jax.tree.map(jnp.asarray, grads), st,
                           jax.tree.map(jnp.asarray, params))
        ref = jax.tree.map(N, optax.apply_updates(params, upd))
        psys = tt.NeRFSystem(p.h, p.tr, device="cpu", params=params)
        psys.adam_state_from_numpy({"mu": mu, "nu": nu, "count": count})
        leaves = [t for _, t in tt.tree_leaves(psys.params)]
        gl = tt.clip_by_global_norm([T(g) for _, g in tt.tree_leaves(grads)])
        for t, g in zip(leaves, gl):
            t.grad = g
        psys.optimizer.param_groups[0]["lr"] = psys.lr_at(count)
        psys.optimizer.step()
        _leaf_close(psys.params_to_numpy(), ref, 1e-6, f"param {count}")


def _with_moments(state, mu, nu, count):
    """An optax chain state with the Adam moments and counts replaced."""
    def fix(x):
        if hasattr(x, "mu"):
            return x._replace(mu=jax.tree.map(jnp.asarray, mu),
                              nu=jax.tree.map(jnp.asarray, nu),
                              count=jnp.int32(count))
        if _has_count(x):
            return x._replace(count=jnp.int32(count))
        return x
    return jax.tree.map(fix, state,
                        is_leaf=lambda x: hasattr(x, "mu") or _has_count(x))


def _has_count(x):
    return "count" in getattr(x, "_fields", ())


def N_tree(tree):
    return jax.tree.map(N, tree)


def test_three_step_trajectory_matches(precision="f32"):
    """Three steps from the same state: the losses of each step, the
    update of the three steps together, and the parameters after the
    last (test_torch_train_bf16.py runs the same trajectory with bf16
    tables and MLP operands, with its tolerances)."""
    p = pair(precision)
    losses_j, params_j, states_j = p.jax_steps(3)
    psys = tt.NeRFSystem(p.h, p.tr, device="cpu", params=p.params)
    psys.grid = p.psys.grid
    p0 = psys.params_to_numpy()
    losses_t = [float(psys.train_step(b)["loss"]) for b in p.batches]
    upd = 1e-3 if precision == "f32" else 5e-3
    rtol = 1e-5
    np.testing.assert_allclose(losses_t, losses_j, rtol=rtol)
    _, held = _update_close(p0, psys.params_to_numpy(), params_j, states_j,
                            upd, "update")
    assert held > 1000
    if precision == "f32":
        _leaf_close(psys.params_to_numpy(), params_j, 1e-3, "param")


def test_adam_state_round_trip_and_validate():
    p = pair("f32")
    psys = tt.NeRFSystem(p.h, p.tr, p.psys.test_dataset, device="cpu",
                         params=p.params)
    psys.grid = p.psys.grid
    psys.train_step(p.batches[0])
    st = psys.adam_state_to_numpy()
    other = tt.NeRFSystem(p.h, p.tr, device="cpu",
                          params=psys.params_to_numpy())
    other.grid = p.psys.grid
    other.adam_state_from_numpy(st)
    a = psys.train_step(p.batches[1])
    b = other.train_step(p.batches[1])
    assert float(a["loss"]) == float(b["loss"])
    _leaf_close(other.params_to_numpy(), psys.params_to_numpy(), 0.0,
                "param")
    m = psys.validate()
    assert np.isfinite(m["psnr"]) and 0 < m["ssim"] <= 1
