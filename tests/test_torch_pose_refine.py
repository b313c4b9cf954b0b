"""Port parity of pose refinement (`optimize_ext`) against the JAX
package on CPU: the position cotangent of K2's backward (the plain form
of the position cotangent that `ingp_brick_reduce_bwd_and_pos` writes
beside K2's table backward) against JAX AD of the XLA reduce, one
training step's loss and every gradient leaf (`ext`'s dR and dT
included) against JAX's `train_step` on the hash, per-sample brick and
stream encoders, three steps' losses and `ext` update, the optimiser
(the shared clip, then a constant Adam at 1e-6 for `ext`), and the
checkpoints that carry `ext`.

The steps run on a KITTI-360 fixture (utils/street_fixture.py) with its
cameras inside the scene's box, where JAX's march entry clamps to
NEAR_DISTANCE and its t values carry no gradient, as the port holds them
(models/rendering.py `_march`). Both sides start from the same
parameters and grid and take the same batch and ray jitter; JAX's
grouped stream runs its Pallas kernels through the interpreter.

The tables are scaled per level, coarse to fine by 1e4, 1e3, 1e2 and 10
(rgb a tenth of that): a smooth field, as a trained one is. A field
whose finest level (1024 cells per unit) is unit white noise has
position gradients of ~1000 per unit at every sample, whose sum over an
image's samples, the gradient of its pose, cancels to a fraction of
them: there one ulp of a sample's t, where the port's march rounds
otherwise than XLA (test_torch_train_render.py holds ts to rtol 1e-4),
moves a pose's gradient by ~1e-4 of its value (measured 7e-5 to 1.1e-4
with every level at 1e4). Here: loss to rtol 1e-5; every leaf to 1e-4
of its largest |value| [ext measured 1.7e-5 to 2.4e-5, the density
table 6.5e-5], norm_net's to 3e-4 as in test_torch_train.py; three
steps' ext update to 1e-3 of its largest |value|.

What JAX's ext gradient holds, per path (test_stream_drops_the_dedup_
levels): hash and the per-sample brick path differentiate every level
through the sample positions (XLA; the port's K2 position cotangent);
the stream's dedup levels give none (K1's backward returns a zero lf
cotangent in JAX, and none in the port), its direct levels do.
"""
import contextlib

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from ingp_tpu.data import dataset_dict as jax_datasets
from ingp_tpu.ops import brickgrid as jb
from ingp_tpu.training import trainer as jt
from ingp_tpu_torch.data import dataset_dict
from ingp_tpu_torch.kernels import brickreduce as k2
from ingp_tpu_torch.models.ngp import hash_layout
from ingp_tpu_torch.training import trainer as tt
from ingp_tpu_torch.utils.ckpt import load_ckpt, save_ckpt, slim_state
from ingp_tpu_torch.utils.street_fixture import write_kitti_scene
from tests._torch_threads import one_torch_thread  # noqa: F401
from tests.test_torch_train import N, T, hparams, jax_grouped

R_BATCH = 256
FRAMES = range(4, 12)
LEVEL_SCALE = (1e4, 1e3, 1e2, 1e1)
PATHS = {"hash": dict(encoder="hash", stream_dedup=False),
         "brick": dict(stream_dedup=False),
         "stream": dict()}


@pytest.fixture(scope="module")
def kitti_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("street") / "kitti"
    write_kitti_scene(str(root), frames=FRAMES, img_wh=(44, 12))
    return str(root)


def _kw(root):
    return dict(root_dir=root, frame_start=FRAMES[0], frame_end=FRAMES[-1],
                test_id=[7], nvs=True)


def _smooth(params, cfg, encoder):
    """The tables scaled per level by LEVEL_SCALE (rgb by a tenth)."""
    for name, base in (("density", 1.0), ("rgb", 0.1)):
        gc = getattr(cfg, f"{name}_grid_cfg" if encoder == "hash"
                     else f"{name}_brick_cfg")
        tab = params["model"][f"{name}_table"]
        axis = 1 if encoder == "hash" else 0     # JAX's hash is (F, rows)
        ends = list(gc.offsets[1:]) + [tab.shape[axis]]
        for lvl, (lo, hi) in enumerate(zip(gc.offsets, ends)):
            idx = (slice(None), slice(lo, hi)) if axis else slice(lo, hi)
            tab[idx] *= base * LEVEL_SCALE[lvl]
    return params


def _grads_of(opt_state):
    """{leaf path: clipped gradient} from the Adam moments after one
    step (mu = (1 - b1) g) of both transforms of the multi_transform."""
    out = {}
    for st in jax.tree_util.tree_leaves(
            opt_state, is_leaf=lambda x: hasattr(x, "mu")):
        if not hasattr(st, "mu"):
            continue
        for path, v in jax.tree_util.tree_flatten_with_path(
                st.mu, is_leaf=lambda x: isinstance(x, optax.MaskedNode))[0]:
            if not isinstance(v, optax.MaskedNode):
                key = tuple(getattr(k, "key", getattr(k, "idx", None))
                            for k in path)
                out[key] = N(v) / np.float32(0.1)
    return out


class Case:
    """JAX and port systems on the kitti fixture with pose refinement,
    the same parameters and grid, and three batches with their jitter."""

    def __init__(self, root, path):
        self.h = hparams("f32", dataset_name="kitti", scale=2.0,
                         optimize_ext=True, **PATHS[path])
        self.ctx = jax_grouped if path == "stream" else \
            contextlib.nullcontext
        jtr = jax_datasets["kitti"](split="train", **_kw(root))
        self.tr = dataset_dict["kitti"](split="train", **_kw(root))
        self.jsys = jt.NeRFSystem(self.h, jtr, jtr)
        self.params = _smooth(
            jax.tree.map(lambda a: np.array(a, np.float32), self.jsys.params),
            self.jsys.model_cfg, self.h.encoder)
        self.grid = {k: np.asarray(v) for k, v in self.jsys.grid.items()}
        rng = np.random.default_rng(0)
        self.batches = []
        for _ in range(3):
            b = self.tr.sample_batch(rng, R_BATCH)
            b["noise"] = rng.random(R_BATCH, dtype=np.float32)
            self.batches.append(b)

    def port(self):
        psys = tt.NeRFSystem(self.h, self.tr, device="cpu",
                             params=self.params)
        psys.load_state({"params": self.params, "grid": self.grid})
        return psys

    def jax_steps(self):
        """(losses, opt states, params) after each of three JAX steps."""
        if not hasattr(self, "_jax"):
            j = self.jsys
            params = jax.tree.map(jnp.asarray, self.params)
            opt_state = j.tx.init(params)
            step = jnp.int32(0)
            grid = jax.tree.map(jnp.asarray, self.grid)
            out = ([], [], [])
            with self.ctx():
                for b in self.batches:
                    batch = {k: jnp.asarray(v) for k, v in b.items()
                             if k in j.BATCH_KEYS}
                    params, opt_state, step, aux = j.train_step(
                        params, opt_state, grid["bitfield"],
                        grid["block_table"], j.directions, j.poses, batch,
                        step, j._base_key)
                    out[0].append(float(aux["loss"]))
                    out[1].append(jax.tree.map(
                        lambda x: x if isinstance(x, optax.MaskedNode)
                        else N(x), opt_state,
                        is_leaf=lambda x: isinstance(x, optax.MaskedNode)))
                    out[2].append(jax.tree.map(N, params))
            self._jax = out
        return self._jax


_CASES = {}


def case(root, path):
    if path not in _CASES:
        _CASES[path] = Case(root, path)
    return _CASES[path]


def _port_grads(c):
    psys = c.port()
    b = c.batches[0]
    aux, grads = psys.loss_and_grads(b, T(b["noise"]))
    tt.clip_by_global_norm([g for _, g in tt.tree_leaves(grads)])
    grads["model"] = hash_layout(grads["model"], psys.model_cfg)
    return float(aux["loss"]), dict(tt.tree_leaves(grads))


# ------------------------------------------------ K2's position cotangent

def _pos_case(seed, Lw, n, F, n_rows):
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(n_rows, 32 * F)).astype(np.float32)
    rows = rng.integers(0, n_rows, (Lw, n)).astype(np.int32)
    loc = rng.integers(0, 2, (3, Lw, n)).astype(np.float32)
    loc[:, :, ::7] = -9.0
    frac = rng.uniform(0, 1, (3, Lw, n)).astype(np.float32)
    df = rng.normal(size=(n, Lw * F)).astype(np.float32)
    dj = rng.normal(size=(3, n, Lw * F)).astype(np.float32)
    return table, rows, loc, frac, df, dj


@pytest.mark.parametrize("window,with_jac,bf16", [
    ((0, None), True, False), ((1, 3), True, False),
    ((0, None), False, False), ((0, None), True, True)])
def test_pos_cotangent_plain_matches_ad_of_reduce_feats_jac(window,
                                                           with_jac, bf16):
    """d loss / d frac of the plain version against JAX AD of
    reduce_feats_jac (reduce_feats without a jacobian) w.r.t. frac:
    rtol 1e-5 plus 1e-6 of the largest |value|; the -9 cells exact
    zeros."""
    F, Lw, n = 4, 3, 300
    jac_lo, jac_hi = window
    Fj = (F if jac_hi is None else jac_hi) - jac_lo
    table, rows, loc, frac, df, dj = _pos_case(5, Lw, n, F, 97)
    if bf16:
        table = N(jnp.asarray(table, jnp.bfloat16).astype(jnp.float32))
    cfg = jb.BrickGridConfig(n_levels=Lw, n_features=F, log2_bricks=8)
    sc = np.broadcast_to(np.asarray(cfg.scales, np.float32)[None, :, None],
                         (1, Lw, n))
    lf = np.concatenate([loc, frac, sc, np.zeros((1, Lw, n))],
                        0).astype(np.float32)
    dj = dj.reshape(3, n, Lw, F)[..., jac_lo:jac_lo + Fj].reshape(3, n, -1)
    g = jnp.asarray(table)[rows.reshape(-1)]

    def fwd(fr):
        if with_jac:
            return jb.reduce_feats_jac(cfg, g, loc, fr, n, jac_lo, jac_hi)
        return jb.reduce_feats(cfg, g, loc, fr, n)

    _, vjp = jax.vjp(fwd, jnp.asarray(frac))
    (ref,) = vjp((jnp.asarray(df), jnp.asarray(dj)) if with_jac
                 else jnp.asarray(df))
    storage = T(table).to(torch.bfloat16) if bf16 else T(table)
    out = N(k2.brick_reduce_bwd_pos_plain(storage, T(rows), T(lf), T(df),
                                          T(dj) if with_jac else None, F,
                                          jac_lo, jac_hi))
    ref = N(ref)
    np.testing.assert_allclose(out, ref, rtol=1e-5,
                               atol=1e-6 * np.abs(ref).max())
    marked = loc[0] == -9.0
    assert marked.any() and not out[:, marked].any()


def test_pos_cotangent_rows_outside_the_table_and_chunking(monkeypatch):
    F, Lw, n = 8, 2, 300
    table, rows, loc, frac, df, dj = _pos_case(6, Lw, n, F, 50)
    lf = T(np.concatenate([loc, frac, np.full((1, Lw, n), 9.0),
                           np.zeros((1, Lw, n))], 0).astype(np.float32))
    rows[:, 1::13] = 10 ** 6
    ref = N(k2.brick_reduce_bwd_pos_plain(T(table), T(rows), lf, T(df),
                                          T(dj), F))
    assert not ref[:, :, 1::13].any()
    monkeypatch.setattr(k2, "PLAIN_CHUNK", 16)
    np.testing.assert_array_equal(
        N(k2.brick_reduce_bwd_pos_plain(T(table), T(rows), lf, T(df), T(dj),
                                        F)),
        ref)


@pytest.mark.parametrize("bf16", [False, True])
def test_bwd_and_pos_cpu_path_is_both_plain_versions(bf16):
    """The fused wrapper on CPU tensors: the table gradient of
    brick_reduce_bwd_plain and the position cotangent of
    brick_reduce_bwd_pos_plain, bit for bit; exact zeros on cells marked
    -9, on rows outside the table and on cells whose cotangents are all
    zero."""
    F, Lw, n, R = 4, 3, 200, 60
    table, rows, loc, frac, df, dj = _pos_case(8, Lw, n, F, R)
    rows[:, 3::11] = R + 5
    df = df.reshape(n, Lw, F)
    dj = dj.reshape(3, n, Lw, F)
    df[::5, 1] = 0.0
    dj[:, ::5, 1] = 0.0
    df, dj = df.reshape(n, -1), dj.reshape(3, n, -1)
    lf = T(np.concatenate([loc, frac, np.full((1, Lw, n), 5.0),
                           np.zeros((1, Lw, n))], 0).astype(np.float32))
    storage = T(table).to(torch.bfloat16) if bf16 else T(table)
    grad = torch.zeros((R, 32 * F))
    dpos = k2.brick_reduce_bwd_and_pos(grad, storage, T(rows), lf, T(df),
                                       T(dj), F, bf16=bf16)
    ref_g = k2.brick_reduce_bwd_plain(torch.zeros((R, 32 * F)), T(rows), lf,
                                      T(df), T(dj), F, bf16=bf16)
    ref_p = k2.brick_reduce_bwd_pos_plain(storage, T(rows), lf, T(df),
                                          T(dj), F)
    assert torch.equal(grad, ref_g) and torch.equal(dpos, ref_p)
    assert float(ref_g.abs().max()) > 0 and float(ref_p.abs().max()) > 0
    quiet = np.zeros((Lw, n), bool)
    quiet[1, ::5] = True
    for dead in (loc[0] == -9.0, rows >= R, quiet):
        assert dead.any() and not N(dpos)[:, dead].any()


def test_pos_variant_runs_only_when_lf_needs_a_gradient(monkeypatch):
    """BrickReduceFn's backward reads the position cotangent only for an
    lf that requires a gradient: runs without pose refinement run the
    table backward alone."""
    calls = []
    real = k2.brick_reduce_bwd_and_pos
    monkeypatch.setattr(k2, "brick_reduce_bwd_and_pos",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    from ingp_tpu_torch.ops.gather import table_read
    F, Lw, n = 4, 2, 64
    table, rows, loc, frac, df, _ = _pos_case(7, Lw, n, F, 40)
    master = T(table).requires_grad_()
    for pos in (False, True):
        fr = T(frac).requires_grad_(pos)
        lf = torch.cat([T(loc), fr, torch.full((1, Lw, n), 3.0),
                        torch.zeros((1, Lw, n))])
        feats, _ = k2.brick_reduce_read(table_read(master), T(rows), lf, F,
                                        with_jac=False)
        (feats * T(df)).sum().backward()
        assert master.grad.abs().sum() > 0
        assert len(calls) == int(pos)
        assert (fr.grad is not None) == pos
        master.grad = None
    np.testing.assert_allclose(
        N(fr.grad), N(k2.brick_reduce_bwd_pos_plain(
            T(table), T(rows), lf.detach(), T(df), None, F)), rtol=0)


# ------------------------------------------------------- the whole step

@pytest.mark.parametrize("path", list(PATHS))
def test_ext_gradient_matches_jax_train_step(kitti_root, path):
    """One f32 step: the loss and every clipped gradient leaf (from the
    JAX Adam moments), ext's dR and dT included."""
    c = case(kitti_root, path)
    losses_j, states_j, _ = c.jax_steps()
    g_j = _grads_of(states_j[0])
    loss, g_t = _port_grads(c)
    np.testing.assert_allclose(loss, losses_j[0], rtol=1e-5)
    assert set(g_t) == set(g_j)
    for key, g in g_t.items():
        ref = g_j[key]
        frac = 3e-4 if key[:2] == ("model", "norm_net") else 1e-4
        err, scale = np.abs(N(g) - ref).max(), np.abs(ref).max()
        assert err <= frac * scale, (path, key, err, scale)
    for leaf in ("dR", "dT"):
        assert np.abs(g_j[("ext", leaf)]).max() > 0
        # images outside the batch get exactly nothing
        seen = np.zeros(len(c.tr.poses), bool)
        seen[c.batches[0]["img_idxs"]] = True
        assert not N(g_t[("ext", leaf)])[~seen].any()


def test_stream_drops_the_dedup_levels(kitti_root):
    """JAX's stream ext gradient differs from its per-sample brick one
    (the dedup levels, K1, give the positions nothing) by far more than
    the parity tolerance, and the port's differs the same way."""
    for side in ("jax", "port"):
        ext = {}
        for path in ("brick", "stream"):
            c = case(kitti_root, path)
            ext[path] = _grads_of(c.jax_steps()[1][0])[("ext", "dR")] \
                if side == "jax" else N(_port_grads(c)[1][("ext", "dR")])
        scale = np.abs(ext["brick"]).max()
        assert np.abs(ext["stream"] - ext["brick"]).max() > 1e-2 * scale, \
            side


def test_three_steps_ext_update_matches(kitti_root):
    """Three steps on the per-sample brick path: each step's loss to rtol
    1e-5, the update of ext after the three to 1e-3 of its largest
    |value| (Adam at 1e-6 moves each entry by about 1e-6 a step)."""
    c = case(kitti_root, "brick")
    losses_j, _, params_j = c.jax_steps()
    psys = c.port()
    losses_t = [float(psys.train_step(b)["loss"]) for b in c.batches]
    np.testing.assert_allclose(losses_t, losses_j, rtol=1e-5)
    for leaf in ("dR", "dT"):
        u_t = N(psys.params["ext"][leaf])
        u_j = params_j[-1]["ext"][leaf]
        scale = np.abs(u_j).max()
        assert 1e-6 < scale < 1e-5
        assert np.abs(u_t - u_j).max() <= 1e-3 * scale, leaf


def _late_state(tx, params, mu, nu, count):
    """tx's state for params with every Adam moment and count replaced:
    each transform of the multi_transform keeps its own leaves."""
    def masked(x):
        return isinstance(x, optax.MaskedNode)

    def fix(x):
        if hasattr(x, "mu"):
            pick = (lambda own, full: own if masked(own)
                    else jnp.asarray(full))
            return x._replace(
                mu=jax.tree.map(pick, x.mu, mu, is_leaf=masked),
                nu=jax.tree.map(pick, x.nu, nu, is_leaf=masked),
                count=jnp.int32(count))
        if "count" in getattr(x, "_fields", ()):
            return x._replace(count=jnp.int32(count))
        return x
    return jax.tree.map(fix, tx.init(params), is_leaf=lambda x: hasattr(
        x, "mu") or "count" in getattr(x, "_fields", ()))


def test_ext_optimizer_matches_optax(kitti_root):
    """The shared global-norm clip of 50, then Adam at the cosine rate for
    the network and a constant Adam at 1e-6 for ext, on the same
    gradients and moments at a late count: an unclipped and a clipped
    step, the parameters after it to 1e-6 of each leaf's largest
    |value| (as test_torch_train.py's optimiser test; ext, zero before
    the step, to 1e-6 of its update)."""
    c = case(kitti_root, "brick")
    rng = np.random.default_rng(4)
    params = jax.tree.map(N, c.params)
    params["ext"] = jax.tree.map(
        lambda a: (rng.normal(size=a.shape) * 1e-3).astype(np.float32),
        params["ext"])
    for gscale, count in ((1e-3, 0), (10.0, 12345)):
        grads = jax.tree.map(lambda a: (rng.normal(size=a.shape) * gscale
                                        ).astype(np.float32), params)
        mu = jax.tree.map(lambda a: N(a) * 0 + 1e-4, params)
        nu = jax.tree.map(lambda a: N(a) * 0 + 1e-6, params)
        pj = jax.tree.map(jnp.asarray, params)
        st = _late_state(c.jsys.tx, pj, mu, nu, count)
        upd, _ = jax.jit(c.jsys.tx.update)(jax.tree.map(jnp.asarray, grads),
                                           st, pj)
        ref = jax.tree.map(N, optax.apply_updates(pj, upd))
        psys = tt.NeRFSystem(c.h, c.tr, device="cpu", params=params)
        assert [g["lr"] for g in psys.optimizer.param_groups] == [
            c.h.lr, 1e-6]
        psys.adam_state_from_numpy({"mu": mu, "nu": nu, "count": count})
        gl = tt.clip_by_global_norm([T(g) for _, g in tt.tree_leaves(
            hash_layout(grads, psys.model_cfg))])
        for (_, t), g in zip(tt.tree_leaves(psys.params), gl):
            t.grad = g
        psys.optimizer.param_groups[0]["lr"] = psys.lr_at(count)
        psys.optimizer.step()
        for (path, a), (_, b) in zip(
                tt.tree_leaves(psys.params_to_numpy()), tt.tree_leaves(ref)):
            assert np.abs(N(a) - b).max() <= 1e-6 * np.abs(b).max(), path
        step = N(psys.params["ext"]["dT"]) - params["ext"]["dT"]
        # moved at its own rate, 1e-6, not the network's
        assert 1e-8 < np.abs(step).max() <= 1e-5


def test_checkpoint_carries_ext_and_slim_drops_it(kitti_root, tmp_path):
    c = case(kitti_root, "brick")
    psys = c.port()
    psys.train_step(c.batches[0])
    state = psys.state()
    assert set(state["params"]["ext"]) == {"dR", "dT"}
    assert np.abs(state["opt_state"]["mu"]["ext"]["dR"]).max() > 0
    save_ckpt(tmp_path / "full", state)
    save_ckpt(tmp_path / "slim", slim_state(state))
    other = c.port()
    other.load_state(load_ckpt(tmp_path / "full"))
    for (path, a), (_, b) in zip(tt.tree_leaves(other.params_to_numpy()),
                                 tt.tree_leaves(psys.params_to_numpy())):
        np.testing.assert_array_equal(N(a), N(b), err_msg=str(path))
    a = other.train_step(c.batches[1])
    b = psys.train_step(c.batches[1])
    assert float(a["loss"]) == float(b["loss"])
    np.testing.assert_array_equal(N(other.params["ext"]["dR"]),
                                  N(psys.params["ext"]["dR"]))
    slim = load_ckpt(tmp_path / "slim")
    assert "ext" not in slim["params"] and "opt_state" not in slim
    assert "ext" in slim_state(state, keep_ext=True)["params"]
    fresh = c.port()
    fresh.load_state(slim)
    # a slim checkpoint keeps the system's own (zero) corrections
    assert not N(fresh.params["ext"]["dT"]).any()
