"""The port's debugging aids against the JAX package's:

- `profile_dir`: fit writes a Chrome trace of steps 20-29 after its
  first step (JAX's jax.profiler window), one "train_step" range a step:
  10 for a 32-step fit, and 5 for a 25-step fit, whose window the loop's
  end closes;
- `debug_nans`: with a NaN planted in the density table, JAX's step
  under jax_debug_nans and the port's under hparams.debug_nans both
  raise FloatingPointError; a clean step under the flag equals one
  without it, bit for bit on the CPU; a NaN in the refreshed grid
  raises too;
- `utils/filters.py`: box_filter and guided_filter within 1e-5 of the
  JAX package's cv2-based ones;
- `utils/debug_store.py`: the round trip and `record`.
"""
import json
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ingp_tpu.data.synthetic import SyntheticDataset as JData
from ingp_tpu.training import trainer as jt
from ingp_tpu.utils import filters as jf
from ingp_tpu_torch import train as train_cli
from ingp_tpu_torch.data.synthetic import SyntheticDataset
from ingp_tpu_torch.training import trainer as tt
from ingp_tpu_torch.utils import debug_store
from ingp_tpu_torch.utils import filters as tf
from tests._torch_threads import one_torch_thread  # noqa: F401


def _hparams(**kw):
    h = dict(dataset_name="synthetic", root_dir="", split="train",
             downsample=1.0, scale=0.5, use_skybox=False, use_exposure=False,
             embed_a=False, embed_a_len=4, embed_msk=False, num_classes=7,
             batch_size=128, ray_sampling_strategy="all_images",
             num_epochs=1, normal_epochs=0, steps_per_epoch=32, lr=1e-2,
             density_threshold=1e-2, depth_mono=False, normal_mono=False,
             normal_ref=False, optimize_ext=False, random_bg=False,
             render_semantic=False, chunk_size=2048, seed=0, ckpt_load=None,
             compute_dtype="float32", capacity=8, march_iters=64,
             samples_per_ray=8, grid_size=16, density_L=2, density_F=2,
             density_log2T=10, rgb_L=2, rgb_F=2, rgb_log2T=10)
    h.update(kw)
    return SimpleNamespace(**h)


def _train_steps(path):
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return sum(e.get("name") == "train_step"
               and e.get("cat") == "user_annotation" for e in events)


@pytest.mark.parametrize("steps,spans", [(32, 10), (25, 5)])
def test_profile_dir_traces_steps_20_to_29(steps, spans, tmp_path):
    tr = SyntheticDataset(split="train", img_size=8, n_train=2)
    h = _hparams(steps_per_epoch=steps, profile_dir=str(tmp_path / "p"))
    seen = []
    tt.NeRFSystem(h, tr, device="cpu").fit(
        log_every=0, on_step=lambda s, aux: seen.append(s))
    assert seen == list(range(steps))
    assert _train_steps(tmp_path / "p" / "trace.json") == spans


def test_cli_profile_dir(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(tt, "PROFILE_STEPS", (0, 2))
    m = train_cli.main(["--dataset_name", "synthetic", "--num_epochs", "1",
                        "--normal_epochs", "0", "--steps_per_epoch", "3",
                        "--batch_size", "128", "--downsample", "0.125",
                        "--capacity", "8", "--samples_per_ray", "8",
                        "--march_iters", "64", "--grid_size", "16",
                        "--density_L", "2", "--rgb_L", "2",
                        "--density_log2T", "10", "--rgb_log2T", "10",
                        "--no_save_test", "--profile_dir", "prof"],
                       device="cpu")
    assert np.isfinite(m["psnr"])
    assert _train_steps(tmp_path / "prof" / "trace.json") == 2


def _poisoned(table):
    """A copy of a table with every seventh entry NaN."""
    t = np.array(table, np.float32)
    t.reshape(-1)[::7] = np.nan
    return t


def test_debug_nans_raises_as_jax_does():
    h = _hparams()
    jtr = JData(split="train", img_size=16, n_train=2)
    jsys = jt.NeRFSystem(h, jtr)
    params = jax.tree.map(lambda a: np.array(a, np.float32), jsys.params)
    batch = jtr.sample_batch(np.random.default_rng(0), 128)
    batch["noise"] = np.random.default_rng(1).random(128, dtype=np.float32)
    bad = jax.tree.map(lambda a: a, params)
    bad["model"]["density_table"] = _poisoned(params["model"]
                                              ["density_table"])
    old = jax.config.jax_debug_nans
    jax.config.update("jax_debug_nans", True)
    try:
        with pytest.raises(FloatingPointError):
            p = jax.tree.map(jnp.asarray, bad)
            out = jsys.train_step(
                p, jsys.tx.init(p), jsys.grid["bitfield"],
                jsys.grid["block_table"], jsys.directions, jsys.poses,
                {k: jnp.asarray(v) for k, v in batch.items()
                 if k in jsys.BATCH_KEYS}, jnp.int32(0), jsys._base_key)
            jax.block_until_ready(out)
    finally:
        jax.config.update("jax_debug_nans", old)

    tr = SyntheticDataset(split="train", img_size=16, n_train=2)
    port = tt.NeRFSystem(_hparams(debug_nans=True), tr, device="cpu",
                         params=bad)
    with pytest.raises(FloatingPointError, match="debug_nans"):
        port.train_step(batch)
    # a NaN the grid refresh meets
    port = tt.NeRFSystem(_hparams(debug_nans=True), tr, device="cpu",
                         params=bad)
    with pytest.raises(FloatingPointError, match="grid"):
        port.maybe_update_grid()
    # the flag off: the step runs on, and the NaN reaches the parameters
    quiet = tt.NeRFSystem(h, tr, device="cpu", params=bad)
    quiet.train_step(batch)
    assert not all(bool(torch.isfinite(t).all())
                   for _, t in tt.tree_leaves(quiet.params["model"]))
    # a clean step is the same with the flag as without it
    on = tt.NeRFSystem(_hparams(debug_nans=True), tr, device="cpu",
                       params=params)
    off = tt.NeRFSystem(h, tr, device="cpu", params=params)
    a, b = on.training_step(batch), off.training_step(batch)
    assert float(a["loss"]) == float(b["loss"])
    for (_, x), (_, y) in zip(tt.tree_leaves(on.params),
                              tt.tree_leaves(off.params)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("shape,r", [((37, 53), 1), ((37, 53), 4),
                                     ((20, 11), 7), ((16, 16, 3), 2)])
def test_filters_match_jax(shape, r):
    rng = np.random.default_rng(r)
    p = rng.random(shape).astype(np.float32)
    i = rng.random(shape).astype(np.float32)
    got, ref = tf.box_filter(p, r), jf.box_filter(p, r)
    assert got.dtype == ref.dtype == np.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    np.testing.assert_allclose(tf.guided_filter(p, i, r),
                               jf.guided_filter(p, i, r), rtol=0, atol=1e-5)


def test_debug_store_round_trip():
    debug_store.init()
    for key in ("log_dL_dsigmas", "log_dL_dnormals_diff",
                "log_dL_dnormals_ori"):
        assert debug_store.get_value(key).shape == (1,)
    debug_store.set_value("x", 3)
    assert debug_store.get_value("x") == 3
    v = torch.ones(4, requires_grad=True)
    w = v * 2
    w.register_hook(debug_store.record("dL_dw"))
    (w * 3).sum().backward()
    got = debug_store.get_value("dL_dw")
    assert isinstance(got, np.ndarray)
    np.testing.assert_array_equal(got, np.full(4, 3.0, np.float32))
    assert torch.equal(v.grad, torch.full((4,), 6.0))
    debug_store.init()
    with pytest.raises(KeyError):
        debug_store.get_value("x")
