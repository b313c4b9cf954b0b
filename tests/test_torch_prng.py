"""The port's PRNG (ingp_tpu_torch/core/prng.py) against jax.random on
the CPU: keys, split, fold_in, uniform over the ranges the trainer draws
and randint bit for bit, each drawn on the host (numpy) and through
torch on a device; normal to rtol 1e-5 (torch.erfinv against
XLA's, measured 3.3e-6 relative, 1.3e-5 absolute at |x| 3.9);
and a NeRFSystem's initial parameters, brick and hash, equal to the JAX
system's of the same seed."""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ingp_tpu.data.synthetic import SyntheticDataset as JData
from ingp_tpu.training import trainer as jt
from ingp_tpu_torch.core import prng
from ingp_tpu_torch.data.synthetic import SyntheticDataset
from ingp_tpu_torch.training import trainer as tt
from tests.test_torch_faults import _hparams
from tests._torch_threads import one_torch_thread  # noqa: F401


def _key(k):
    return tuple(int(v) for v in np.asarray(jax.random.key_data(k)))


@pytest.mark.parametrize("seed", [0, 1, 20220806])
def test_keys_split_fold_in(seed):
    k = jax.random.PRNGKey(seed)
    assert _key(k) == prng.prng_key(seed)
    assert [_key(x) for x in jax.random.split(k, 10)] == prng.split(
        prng.prng_key(seed), 10)
    for d in (0, 7, 599, 2 ** 31 + 5):
        assert _key(jax.random.fold_in(k, d)) == prng.fold_in(
            prng.prng_key(seed), d)


@pytest.mark.parametrize("lo, hi, shape", [
    (0.0, 1.0, (1001,)), (-0.5, 0.5, (4096, 3)), (-1.0, 1.0, (777, 3)),
    (-1e-4, 1e-4, (64, 256)), (-1 / np.sqrt(128), 1 / np.sqrt(128),
                               (128, 32))])
@pytest.mark.parametrize("device", [None, "cpu"])
def test_uniform_bitwise(lo, hi, shape, device):
    k = jax.random.fold_in(jax.random.PRNGKey(3), 11)
    ref = np.asarray(jax.random.uniform(k, shape, minval=lo, maxval=hi))
    mine = prng.uniform(_key(k), shape, lo, hi, device).numpy()
    np.testing.assert_array_equal(mine, ref)


@pytest.mark.parametrize("span", [512, 32768, 2 ** 21, 1000])
@pytest.mark.parametrize("device", [None, "cpu"])
def test_randint_bitwise(span, device):
    k = jax.random.fold_in(jax.random.PRNGKey(5), span)
    ref = np.asarray(jax.random.randint(k, (3000,), 0, span,
                                        dtype=jnp.int32))
    np.testing.assert_array_equal(
        prng.randint(_key(k), (3000,), 0, span, device).numpy(), ref)


def test_normal_close():
    k = jax.random.PRNGKey(9)
    ref = np.asarray(jax.random.normal(k, (2000, 4)))
    np.testing.assert_allclose(prng.normal(_key(k), (2000, 4)).numpy(), ref,
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("encoder", ["brick", "hash"])
def test_system_init_is_the_jax_systems(encoder):
    h = _hparams(encoder=encoder, seed=7)
    jsys = jt.NeRFSystem(h, JData(split="train", img_size=8, n_train=2))
    psys = tt.NeRFSystem(h, SyntheticDataset(split="train", img_size=8,
                                             n_train=2), device="cpu")
    mine = psys.params_to_numpy()["model"]
    ref = jsys.params["model"]
    for (path, a), (_, b) in zip(tt.tree_leaves(mine), tt.tree_leaves(ref)):
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=str(path))
