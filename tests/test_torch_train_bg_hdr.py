"""Port parity of the training step with the random background, the HDR
tonemapper and the Playground flags at bf16, ingp_tpu_torch against
ingp_tpu on CPU, with test_torch_train_features.py's set-up, checks and
bounds (split from it so that each file runs in about a minute):

- random_bg on the port's own draw of the background, which must be
  JAX's (split(fold_in(PRNGKey(seed + 1), step))[1]);
- use_exposure (the HDR tonemapper) with the unit-exposure anchor;
- configs/Playground.txt's model flags (embed_a, embed_a_len 8,
  embed_msk, random_bg) at bf16 storage and compute;
- a per-ray exposure, on which JAX's own training step fails (its log,
  (R, 1), is added to per-sample (K, 1) log radiance,
  ingp_tpu/models/rendering.py:219, ingp_tpu/models/ngp.py:424-427), is
  refused by name.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tests.test_torch_train import R_BATCH, jax_grouped
from tests.test_torch_train_features import (BF16_BOUNDS, check_case,
                                             check_step, setup)
from tests._torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("case", ["random_bg", "hdr, unit anchor"])
def test_feature_step_matches(case):
    check_case(case)


def test_playground_step_matches_bf16():
    """test_torch_train_bf16.py's bounds [norm_net 2.1e-2, rgb_table
    3.4e-3, xyz_net 2.7e-3, embedding_a 1.3e-3, the rest <= 1.7e-3]."""
    check_step("playground", 0, BF16_BOUNDS, full=False)


def test_per_ray_exposure_is_refused_as_jax_fails():
    s = setup("hdr")
    b = dict(s.batches[0])
    b["exposure"] = np.full((R_BATCH, 1), 0.5, np.float32)
    j = s.jsys
    p = jax.tree.map(jnp.asarray, s.params)
    with jax_grouped(), pytest.raises(TypeError, match="broadcast"):
        j.train_step(p, j.tx.init(p), s.bits, s.table, j.directions,
                     j.poses, {k: jnp.asarray(v) for k, v in b.items()
                               if k in j.BATCH_KEYS},
                     jnp.int32(0), j._base_key)
    with pytest.raises(NotImplementedError, match="per-ray exposure"):
        s.port().train_step(b)
