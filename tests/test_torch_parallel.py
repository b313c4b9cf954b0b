"""The port's data-parallel step (ingp_tpu_torch/parallel, NeRFSystem
over a World) against JAX's shard_map step on its mesh of virtual CPU
devices (ingp_tpu/parallel/mesh.py make_mesh, tests/conftest.py's 8
devices), with all n ranks in one process (`parallel.make_mesh(n)`: the
per-rank bodies run one after the other and the collectives reduce over
them in memory; tests/test_torch_distributed.py runs real processes).

- n = 2, the bench's stream-brick step at a small size (2 levels a
  table, encode chunks of 1024 samples; the JAX stream through its
  interpreted Pallas kernels), one step on the same global
  batch, noise and parameters, at a binding (capacity 32, 16 samples a
  ray) and a non-binding (16 / 16) budget: each shard marches, sorts,
  compacts and encodes its own 128 rays against its own budget, so the
  binding case keeps JAX's per-shard sample sets, not the single
  device's. The loss to rtol 1e-5, the update to 1e-4 of each leaf's
  largest (on the entries above Adam's floor) and the parameters to
  1e-3: the port's one-step bounds (tests/test_torch_train.py).
- n = 8: the sharded test render of a 30x30 view (900 rays: the lone
  chunk pads to 904) against JAX's at rtol 1e-4, atol 1e-5 (the bound of
  tests/test_parallel.py:108-133), and the same view from the port's
  one-device render; the maximum of the stream's run counts over the 8
  shards with its -1 sentinel on a step that measures none, and the
  caps adopted from it, equal to JAX's (as test_autocal_under_mesh_pmax).
- The collectives alone: the bucketed mean and maximum of trees, the
  gathered rows and the shard split.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ingp_tpu.data.synthetic import SyntheticDataset as JData
from ingp_tpu.ops import pack as jp
from ingp_tpu.ops.march import build_block_table
from ingp_tpu.parallel.mesh import make_mesh as jax_mesh
from ingp_tpu.training import trainer as jt
from ingp_tpu_torch.data.synthetic import SyntheticDataset, \
    sphere_density_grid
from ingp_tpu_torch.grid.occupancy import grid_from_density
from ingp_tpu_torch.parallel import (all_gather_metrics, broadcast_int,
                                     is_main_process)
from ingp_tpu_torch.parallel import mesh as pm
from ingp_tpu_torch.training import trainer as tt
from tests.test_torch_train import (N, T, _leaf_close, _update_close,
                                    hparams, jax_grouped)
from tests._torch_threads import one_torch_thread  # noqa: F401

R = 256


def _systems(h, n, img_size=24, n_train=4, scale=(1e4, 1e3)):
    """A JAX system on make_mesh(n) and a port system on a world of n
    ranks, with the same parameters (the JAX system's, tables scaled by
    `scale`) and the same grid (the scene's spheres)."""
    jtr = JData(split="train", img_size=img_size, n_train=n_train)
    jte = JData(split="test", img_size=img_size, n_test=1)
    jsys = jt.NeRFSystem(h, jtr, jte, mesh=jax_mesh(n))
    params = jax.tree.map(lambda a: np.array(a, np.float32), jsys.params)
    params["model"]["density_table"] *= scale[0]
    params["model"]["rgb_table"] *= scale[1]
    cfg = jsys.model_cfg
    dg = sphere_density_grid(cfg.grid_size, cfg.cascades, cfg.scale)
    bits = jp.packbits_u32(dg.reshape(-1), 0.5)
    jsys.params = jax.tree.map(jnp.asarray, params)
    jsys.opt_state = jsys.tx.init(jsys.params)
    jsys.grid = {**jsys.grid, "density_grid": jnp.asarray(dg),
                 "bitfield": bits,
                 "block_table": build_block_table(bits, cfg.grid_size,
                                                  cfg.cascades)}
    tr = SyntheticDataset(split="train", img_size=img_size, n_train=n_train)
    te = SyntheticDataset(split="test", img_size=img_size, n_test=1)
    psys = tt.NeRFSystem(h, tr, te, device="cpu", params=params,
                         world=pm.make_mesh(n))
    psys.grid = grid_from_density(psys.grid, T(dg), 0.5, cfg.grid_size,
                                  cfg.cascades)
    return jsys, psys, params


@pytest.mark.parametrize("capacity", [32, 16], ids=["binding",
                                                    "non-binding"])
def test_two_rank_step_matches_jax_mesh(capacity):
    h = hparams("f32", capacity=capacity, samples_per_ray=16, density_L=2,
                rgb_L=2, encode_chunk=1024)
    jsys, psys, params = _systems(h, 2)
    rng = np.random.default_rng(1)
    batch = psys.train_dataset.sample_batch(rng, R)
    batch["noise"] = rng.random(R, dtype=np.float32)
    with jax_grouped():
        jp_, jst, _, jaux = jsys.train_step(
            jsys.params, jsys.opt_state, jsys.grid["bitfield"],
            jsys.grid["block_table"], jsys.directions, jsys.poses,
            {k: jnp.asarray(v) for k, v in batch.items()
             if k in jsys.BATCH_KEYS}, jnp.int32(0), jsys._base_key)
    aux = psys.train_step(batch)
    np.testing.assert_allclose(float(aux["loss"]), float(jaux["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(aux["s_per_ray"]),
                               float(jaux["s_per_ray"]), rtol=1e-6)
    np.testing.assert_allclose(float(aux["psnr"]), float(jaux["psnr"]),
                               rtol=1e-5)
    p_jax = jax.tree.map(N, jp_)
    _, held = _update_close(params, psys.params_to_numpy(), p_jax, [jst],
                            1e-4, "update")
    assert held > 1000
    _leaf_close(psys.params_to_numpy(), p_jax, 1e-3, "param")


def _hash_hparams(**kw):
    """tests/test_parallel.py's small hash configuration."""
    return hparams("f32", **{
        "encoder": "hash", "stream_dedup": False, "capacity": 16,
        "samples_per_ray": 16, "march_iters": 1024, "density_F": 2,
        "rgb_F": 2, "chunk_size": 4096, **kw})


def test_eight_rank_render_matches_jax_mesh():
    h = _hash_hparams()
    jsys, psys, params = _systems(h, 8, img_size=30, n_train=2)
    pose = psys.test_dataset.poses[0]
    ref = jsys.render_image(pose)
    got = psys.render_image(pose)
    assert got["rgb"].shape == (900, 3)
    assert got["total_samples"] == int(ref["total_samples"]) > 0
    for k in ("rgb", "depth", "opacity"):
        np.testing.assert_allclose(N(got[k]), N(ref[k]), rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    assert N(got["opacity"]).max() > 0.01
    one = tt.NeRFSystem(h, psys.train_dataset, psys.test_dataset,
                        device="cpu", params=params)
    one.grid = psys.grid
    np.testing.assert_allclose(N(got["rgb"]), N(one.render_image(pose)[
        "rgb"]), rtol=1e-4, atol=1e-5)


def test_eight_rank_stream_runs_max_and_caps_match_jax_mesh():
    h = hparams("f32", stream_autocal=True, stream_tile=128,
                density_log2T=14, rgb_log2T=14, capacity=16,
                samples_per_ray=16, density_L=2, rgb_L=2)
    jsys, psys, _ = _systems(h, 8)
    rng = np.random.default_rng(2)
    runs = {"jax": [], "port": []}
    for step in (15, 16):
        batch = psys.train_dataset.sample_batch(rng, R)
        if step == 15:
            jsys.global_step = psys.global_step = step
            jsys._step_dev = None
        # step 15 measures (its count is read after the step, at 16)
        aux_j = jsys.training_step(dict(batch))
        aux_p = psys.training_step(dict(batch))
        runs["jax"].append(N(aux_j["stream_runs"]))
        runs["port"].append(N(aux_p["stream_runs"]))
    np.testing.assert_array_equal(runs["port"][0], runs["jax"][0])
    assert (runs["port"][0] > 0).all()
    # step 16 measures nothing: the sentinel survives the maximum
    assert (runs["port"][1] == -1).all() and (runs["jax"][1] == -1).all()
    assert psys.model_cfg.stream_caps == jsys.model_cfg.stream_caps
    assert psys.model_cfg.stream_caps is not None


def test_collectives_in_one_process():
    w = pm.make_mesh(3)
    trees = [{"a": torch.full((5,), float(r)), "b": [torch.tensor(r * 2.0),
                                                     torch.arange(4.0) * r]}
             for r in range(3)]
    mean = pm.all_reduce_mean(w, trees)
    assert torch.equal(mean["a"], torch.full((5,), 1.0))
    assert torch.equal(mean["b"][1], torch.arange(4.0))
    assert float(mean["b"][0]) == 2.0
    ints = [torch.tensor([r, -1, 5 - r], dtype=torch.int32)
            for r in range(3)]
    assert pm.all_reduce_max(w, ints).tolist() == [2, -1, 5]
    rows = pm.gather_rows(w, [torch.full((2, 3), float(r))
                              for r in range(3)])
    assert rows[:, 0].tolist() == [0, 0, 1, 1, 2, 2]
    batch = {"x": np.arange(12), "y": np.arange(24).reshape(12, 2)}
    assert pm.shard_batch(w, batch, 2)["x"].tolist() == [8, 9, 10, 11]
    with pytest.raises(ValueError, match="split"):
        pm.shard_batch(pm.make_mesh(5), batch, 0)
    # outside a process group the host collectives are the identity
    assert is_main_process() and broadcast_int(None) is None
    assert broadcast_int(7) == 7
    assert all_gather_metrics([1, 2.5]) == [1.0, 2.5]
    # buckets: one per dtype, a new one past BUCKET_ELEMENTS
    leaves = [torch.zeros(3), torch.zeros(2, dtype=torch.int32),
              torch.zeros(pm.BUCKET_ELEMENTS), torch.zeros(4)]
    assert [idx for _, idx in pm._buckets(leaves)] == [[0], [1], [2], [3]]
