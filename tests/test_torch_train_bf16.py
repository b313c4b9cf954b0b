"""The training step of test_torch_train.py with bf16 tables and bf16
MLP operands (bench.py's precision), ingp_tpu_torch against ingp_tpu on
CPU. A value that lands next to a bf16 rounding boundary can round the
other way on one side and move that term by a bf16 step (2^-8
relative), so the bf16 comparisons are looser than the f32 ones
(measured values in brackets):
- one step's loss to rtol 1e-5 [equal to the last bit];
- every clipped gradient leaf to 6e-3 of the leaf's largest |value|
  [4.5e-3], norm_net's to 3e-2 [2.1e-2]: its gradients are ~1e-7 and
  come only through the Ref-NeRF term of the normalised density
  gradient. Dropping the jacobian cotangent from K1's or K2's backward
  moves density_table's error to 7.6e-3 or 1.4e-2, beyond its limit;
  the bf16 rounding points of those backward kernels are held by
  test_torch_grad.py, where 99% of the entries must agree to f32
  rounding (the whole step's bf16 noise hides them here);
- the 3-step trajectory's losses to rtol 1e-5 [8.3e-7], and its update
  (on the entries of test_torch_train.py's Adam mask) to 5e-3 of the
  largest |update| [2.4e-3].
"""
import numpy as np
import jax

from ingp_tpu_torch.training import trainer as tt
from tests import test_torch_train as base
from tests._torch_threads import one_torch_thread  # noqa: F401


def test_train_step_grads_match_bf16():
    p = base.pair("bf16")
    losses_j, _, (opt_j,) = p.jax_steps(1)
    mu_j, _ = base._adam_moments(opt_j)
    g_j = jax.tree.map(lambda m: base.N(m) / np.float32(1 - 0.9), mu_j)
    psys = tt.NeRFSystem(p.h, p.tr, device="cpu", params=p.params)
    psys.grid = p.psys.grid
    b = p.batches[0]
    aux, grads = psys.loss_and_grads(b, base.T(b["noise"]))
    np.testing.assert_allclose(float(aux["loss"]), losses_j[0], rtol=1e-5)
    tt.clip_by_global_norm([g for _, g in tt.tree_leaves(grads)])
    for name in grads["model"]:
        frac = 3e-2 if name == "norm_net" else 6e-3
        base._leaf_close(grads["model"][name], g_j["model"][name], frac,
                         name)


def test_three_step_trajectory_matches_bf16():
    base.test_three_step_trajectory_matches("bf16")
