"""Port parity of the training step and the test render with the
Instant-NGP++ features on, ingp_tpu_torch against ingp_tpu on CPU, at
test_torch_train.py's size and set-up (the same numpy parameters,
sphere grid, batch and ray jitter on both sides) but on the per-sample
brick encoder (stream_dedup off): the features act after the encoders,
whose stream path test_torch_train.py holds, and the JAX stream path's
interpreted kernels would take a minute per configuration here. (On
the stream encoder every case below met the same bounds.) The cases:

- the feature set of JAX's own test (tests/test_training.py:74) less
  pose refinement: skybox, appearance embeddings, the transient mask,
  semantics and both normal losses; with the skybox's gate closed (step
  0) and open (step WARMUP_STEPS, the optimiser's count set there on
  both sides);
- render_image with an appearance embedding and the skybox;
- a JAX state() holding the mask and its Adam moments, loaded into the
  port, gives JAX's next step.

test_torch_train_bg_hdr.py runs random_bg, use_exposure with the
unit-exposure anchor, the Playground flags at bf16 and the per-ray
exposure through the same set-up (`Setup`, `check_case`).

The tables are scaled up so that the encoders' features matter, and the
appearance codes (x10) and the mask's table (x1e4) so that they move the
outputs. (At x30 one first-layer pre-activation of rgb_net, of 524,288,
lands within rounding of zero and its relu opens on one side only:
that one hidden unit's gradient column then differs by 2.7e-3 of the
largest value and every other column agrees to 1e-6; a tie, not a
fault, so the codes are scaled where none lands.) Bounds are
test_torch_train.py's for f32 (loss rtol 1e-5; every clipped gradient
leaf, the new ones too, to 1e-4 of its largest |value|, norm_net's to
3e-4, and the others named in F32_BOUNDS and GATE_OPEN_BOUNDS with their
reasons; the update to 1e-4 on the entries above ADAM_FLOOR; the
parameters to 1e-3) and test_torch_train_bf16.py's for bf16 (loss rtol
1e-5; gradient leaves to 6e-3, norm_net's to 3e-2); the render
test_torch_render.py's f32 ones (rtol 1e-4, atol 2e-5; normal_raw atol
1e-3). Measured values are in the cases' comments.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ingp_tpu.data.synthetic import SyntheticDataset as JData
from ingp_tpu.models import rendering as jr
from ingp_tpu.ops import pack as jp
from ingp_tpu.ops.march import build_block_table
from ingp_tpu.training import trainer as jt

from ingp_tpu_torch.data.synthetic import SyntheticDataset, \
    sphere_density_grid
from ingp_tpu_torch.grid.occupancy import grid_from_density
from ingp_tpu_torch.models import ngp as tngp
from ingp_tpu_torch.training import trainer as tt
from tests.test_torch_train import (N, R_BATCH, T, _adam_moments,
                                    _leaf_close, _update_close,
                                    _with_moments, hparams, jax_grouped)
from tests._torch_threads import one_torch_thread  # noqa: F401

WARMUP = tt.NeRFSystem.WARMUP_STEPS

# tests/test_training.py:74 less optimize_ext
FEATURE_SET = dict(use_skybox=True, embed_a=True, embed_msk=True,
                   render_semantic=True, normal_ref=True, normal_mono=True)
SETS = {
    "feature set": ("f32", FEATURE_SET),
    "random_bg": ("f32", dict(random_bg=True)),
    "hdr": ("f32", dict(use_exposure=True)),
    # configs/Playground.txt's model flags
    "playground": ("bf16", dict(embed_a=True, embed_a_len=8, embed_msk=True,
                                random_bg=True)),
}
UNIT_EXPOSURE_RGB = 0.5


class Setup:
    """A JAX system and the port's dataset and grid for one hparams set,
    from the same numpy parameters and sphere grid."""

    def __init__(self, name):
        precision, kw = SETS[name]
        self.h = h = hparams(precision, stream_dedup=False, **kw)
        jtr = JData(split="train", img_size=24, n_train=4)
        jte = JData(split="test", img_size=24, n_test=1)
        self.tr = SyntheticDataset(split="train", img_size=24, n_train=4)
        self.te = SyntheticDataset(split="test", img_size=24, n_test=1)
        if h.use_exposure:
            # the HDR anchor's target, read where the system is built
            jtr.unit_exposure_rgb = self.tr.unit_exposure_rgb = \
                UNIT_EXPOSURE_RGB
        self.jsys = jt.NeRFSystem(h, jtr, jte)
        params = jax.tree.map(lambda a: np.array(a, np.float32),
                              self.jsys.params)
        params["model"]["density_table"] *= 1e4
        params["model"]["rgb_table"] *= 1e3
        params["embedding_a"] *= 10.0
        if "msk" in params:
            params["msk"]["table"] *= 1e4
        self.params = params
        cfg = self.jsys.model_cfg
        dg = sphere_density_grid(cfg.grid_size, cfg.cascades, cfg.scale)
        self.bits = jp.packbits_u32(dg.reshape(-1), 0.5)
        self.table = build_block_table(self.bits, cfg.grid_size,
                                       cfg.cascades)
        sys0 = self.port()
        self.grid = grid_from_density(sys0.grid, T(dg), 0.5, cfg.grid_size,
                                      cfg.cascades)
        rng = np.random.default_rng(0)
        self.batches = []
        for _ in range(2):
            b = self.tr.sample_batch(rng, R_BATCH)
            b["noise"] = rng.random(R_BATCH, dtype=np.float32)
            self.batches.append(b)

    def port(self, step=0):
        """The port's system from the same parameters (and grid), its
        optimiser's count and global step at `step`."""
        psys = tt.NeRFSystem(self.h, self.tr, self.te, device="cpu",
                             params=self.params)
        if hasattr(self, "grid"):
            psys.grid = self.grid
        if step:
            zeros = jax.tree.map(np.zeros_like, self.params)
            psys.adam_state_from_numpy({"mu": zeros, "nu": zeros,
                                        "count": step})
        return psys

    def jax_step(self, step):
        """(aux, params after, opt_state after) of JAX's train_step on
        the first batch at `step`, the optimiser's count there too."""
        j = self.jsys
        p = jax.tree.map(jnp.asarray, self.params)
        st = j.tx.init(p)
        if step:
            zeros = jax.tree.map(np.zeros_like, self.params)
            st = _with_moments(st, zeros, zeros, step)
        b = {k: jnp.asarray(v) for k, v in self.batches[0].items()
             if k in j.BATCH_KEYS}
        with jax_grouped():
            p, st, _, aux = j.train_step(p, st, self.bits, self.table,
                                         j.directions, j.poses, b,
                                         jnp.int32(step), j._base_key)
        return (jax.tree.map(N, aux), jax.tree.map(N, p),
                jax.tree.map(N, st))


_SETUPS = {}


def setup(name):
    if name not in _SETUPS:
        _SETUPS[name] = Setup(name)
    return _SETUPS[name]


# gradient bounds, as fractions of each leaf's largest |value|, by leaf
# (a model leaf's name, "embedding_a" or "msk"; None: the rest); the
# measured worst values are in each case's comment
F32_BOUNDS = {None: 1e-4, "norm_net": 3e-4,
              # the mask reaches the loss through every ray's colour error
              # (1 - mask)(rgb - gt)^2, whose sum over a table entry's
              # rays cancels, as norm_net's Ref-NeRF term does
              "msk": 3e-4}
# with the skybox's gate open, its opacity cotangent -sky . dC nearly
# cancels the colour's in each sample's dsigma: on the step's recorded
# composite inputs K3's dsigma is 4.3e-6 (JAX's AD) and 2.7e-6 (the
# port's closed form) of its largest value from a float64 evaluation,
# against 1.7e-7 with the gate closed, and the density branch sums
# those into table entries that cancel further. The port's density
# table gradient moves by 6.3e-7 of its largest value when K3's backward
# runs in float64; JAX's is 1.2e-4 from it (the skybox alone).
GATE_OPEN_BOUNDS = {**F32_BOUNDS, "density_table": 3e-4, "xyz_net": 3e-4}
BF16_BOUNDS = {None: 6e-3, "norm_net": 3e-2}


def check_step(name, step, bounds, full=True):
    """One step of hparams set `name` at `step` on both sides: the loss
    and its terms, every clipped gradient leaf (as params_to_numpy lays
    them out) to its bound, and with full the update (on the entries
    above ADAM_FLOOR) and the parameters after it, except the mask's.
    Returns the port's system after the step and its gradients."""
    s = setup(name)
    aux_j, params_j, st_j = s.jax_step(step)
    mu_j, _ = _adam_moments(st_j)
    psys = s.port(step)
    b = s.batches[0]
    aux, grads = psys.loss_and_grads(b, T(b["noise"]))
    np.testing.assert_allclose(float(aux["loss"]), aux_j["loss"], rtol=1e-5)
    assert set(aux["loss_terms"]) == set(aux_j["loss_terms"])
    for k, v in aux_j["loss_terms"].items():
        np.testing.assert_allclose(float(aux["loss_terms"][k]), v,
                                   rtol=1e-4, atol=1e-9, err_msg=k)
    tt.clip_by_global_norm([g for _, g in tt.tree_leaves(grads)])
    g_port = tngp.params_to_numpy(grads, psys.model_cfg)
    g_j = jax.tree.map(lambda m: m / np.float32(1 - 0.9), mu_j)
    assert jax.tree.structure(g_port) == jax.tree.structure(g_j)
    leaves = [(k, g_port["model"][k], g_j["model"][k])
              for k in g_port["model"]]
    leaves += [(k, g_port[k], g_j[k]) for k in g_port if k != "model"]
    for leaf, a, ref in leaves:
        _leaf_close(a, ref, bounds.get(leaf, bounds[None]), leaf)
    if full:
        # the mask's gradients span a wide range: entries just above
        # ADAM_FLOOR carry tens of percent of relative error from
        # differences at 1e-4 of the largest gradient, and Adam's first
        # update (~ lr sign g) takes them whole; its gradients are held
        # above, the optimiser's arithmetic by test_torch_train.py
        p0 = psys.params_to_numpy()
        psys.train_step(b)
        after = psys.params_to_numpy()
        for t in (p0, after, params_j):
            t.pop("msk", None)
        _, held = _update_close(p0, after, params_j, [_no_msk(st_j)], 1e-4,
                                "update")
        assert held > 500
        _leaf_close(after, params_j, 1e-3, "param")
    return psys, g_port


def _no_msk(opt_state):
    """An optax state with the mask's subtree left out of its moments."""
    def drop(x):
        if hasattr(x, "mu"):
            return x._replace(
                mu={k: v for k, v in x.mu.items() if k != "msk"},
                nu={k: v for k, v in x.nu.items() if k != "msk"})
        return x
    return jax.tree.map(drop, opt_state, is_leaf=lambda x: hasattr(x, "mu"))


# name -> (hparams set, step, bounds); measured worst gradient leaves in
# the comments (fractions of their largest values)
CASES = {
    # msk.table 8.1e-5, xyz_net 5.0e-5, norm_net 3.8e-5, the rest <= 3.3e-5
    "feature set, gate closed": ("feature set", 0, F32_BOUNDS),
    # xyz_net 2.4e-4, density_table 2.3e-4, msk.table 8.1e-5, norm_net
    # 3.8e-5, the rest <= 3.5e-5
    "feature set, gate open": ("feature set", WARMUP, GATE_OPEN_BOUNDS),
    # norm_net 1.0e-4, xyz_net 6.5e-5, the rest <= 2e-5
    "random_bg": ("random_bg", 0, F32_BOUNDS),
    # norm_net 1.0e-4, xyz_net 4.1e-5, the rest <= 2e-5
    "hdr, unit anchor": ("hdr", 0, F32_BOUNDS),
}


def check_case(case):
    """check_step of CASES[case], then what the case's feature must show
    in the gradients or the draws."""
    name, step, bounds = CASES[case]
    psys, g = check_step(name, step, bounds)
    model = g["model"]
    if name == "feature set":
        # the skybox learns only once its gate is open
        assert np.abs(model["skybox_net"][0]["w"]).max() > 0 if step \
            else not any(np.abs(x).max() for x in
                         jax.tree.leaves(model["skybox_net"]))
        assert np.abs(g["embedding_a"]).max() > 0
        assert np.abs(g["msk"]["table"]).max() > 0
    if name == "random_bg":
        # the port's draw is JAX's: split(fold_in(PRNGKey(seed+1), step))[1]
        key = jax.random.fold_in(setup(name).jsys._base_key, step)
        ref = jax.random.uniform(jax.random.split(key)[1], (3,))
        np.testing.assert_array_equal(
            N(psys.step_draws(1, step)["bg_color"]), N(ref))
    if name == "hdr":
        assert all(np.abs(x).max() > 0 for ch in "rgb" for x in
                   jax.tree.leaves(model[f"tonemapper_{ch}"]))


@pytest.mark.parametrize("case", ["feature set, gate closed",
                                  "feature set, gate open"])
def test_feature_step_matches(case):
    check_case(case)


def test_render_image_with_embedding_and_skybox_matches():
    """render_image with image 0's code (the default) and another
    image's, on both sides."""
    s = setup("feature set")
    j = s.jsys
    j.params = jax.tree.map(jnp.asarray, s.params)
    j.grid = dict(j.grid, bitfield=jnp.asarray(s.bits),
                  block_table=jnp.asarray(s.table))
    psys = s.port()
    pose = s.te.poses[0]
    codes = (None, s.params["embedding_a"][2:3])
    try:
        with jax_grouped():
            jr.render_rays_test.clear_cache()
            refs = [jax.tree.map(N, j.render_image(pose, embedding=c))
                    for c in codes]
    finally:
        jr.render_rays_test.clear_cache()
    outs = [psys.render_image(pose, embedding=c) for c in codes]
    for out, ref in zip(outs, refs):
        assert int(out["total_samples"]) == int(ref["total_samples"]) > 0
        assert (ref["opacity"] > 0.01).any() and (ref["opacity"] == 0).any()
        for k in ("rgb", "depth", "opacity", "normal_pred",
                  "semantic_probs", "points"):
            np.testing.assert_allclose(N(out[k]), ref[k], rtol=1e-4,
                                       atol=2e-5, err_msg=k)
        np.testing.assert_allclose(N(out["normal_raw"]), ref["normal_raw"],
                                   rtol=0, atol=1e-3)
    # the code and the skybox each change the image (the field is thin:
    # opacity at most ~0.04)
    assert np.abs(refs[0]["rgb"] - refs[1]["rgb"]).max() > 1e-4
    sky = ~(refs[0]["opacity"] > 0)
    assert sky.any() and np.abs(refs[0]["rgb"][sky]).max() > 1e-2


def test_jax_state_with_mask_loads_into_port():
    """A JAX state() after one training_step (step 1 on the sphere grid,
    so that no grid refresh runs), with the mask's table and Adam
    moments in the JAX layout, loaded into the port: the mask's
    parameters and moments bitwise, back through the port's state() in
    the JAX layout; the next step's loss to rtol 1e-5 and the parameters
    after it to 1e-3 of each leaf's largest value (the mask's left out
    for check_step's reason)."""
    s = setup("feature set")
    j = s.jsys
    j.params = jax.tree.map(jnp.asarray, s.params)
    j.opt_state = j.tx.init(j.params)
    j.grid = dict(j.grid, bitfield=jnp.asarray(s.bits),
                  block_table=jnp.asarray(s.table))
    j.global_step, j._step_dev = 1, None
    with jax_grouped():
        j.training_step(s.batches[0])
        st = jax.tree.map(np.asarray, j.state())
        mu, nu = _adam_moments(st["opt_state"])
        # the optimiser's count (1) trails the global step (2) here
        count, = {int(x.count) for x in jax.tree_util.tree_leaves(
            st["opt_state"], is_leaf=lambda x: hasattr(x, "mu"))
            if hasattr(x, "mu")}
        state = {"params": st["params"],
                 "opt_state": {"mu": mu, "nu": nu, "count": count},
                 "grid": st["grid"], "step": int(st["step"])}
        assert state["params"]["msk"]["table"].shape[0] == 2
        psys = tt.NeRFSystem(s.h, s.tr, device="cpu", seed=5)
        psys.load_state(state)
        assert psys.global_step == 2
        back = psys.state()
        for ours, ref in ((back["params"], st["params"]),
                          (back["opt_state"]["mu"], mu),
                          (back["opt_state"]["nu"], nu)):
            _leaf_close(ours["msk"], ref["msk"], 0.0, "msk")
        aux_j = j.training_step(s.batches[1])
    aux_t = psys.training_step(s.batches[1])
    np.testing.assert_allclose(float(aux_t["loss"]), float(aux_j["loss"]),
                               rtol=1e-5)
    ours = psys.params_to_numpy()
    ref = jax.tree.map(np.asarray, j.params)
    ours.pop("msk"), ref.pop("msk")
    _leaf_close(ours, ref, 1e-3, "param")
