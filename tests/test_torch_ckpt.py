"""Checkpoints of the port (ingp_tpu_torch/utils/ckpt.py and
NeRFSystem.state / save / load / load_state / fit's epoch checkpoints):
a save/load round trip gives the parameters, Adam moments, grid and
step back exactly, on the brick and the hash encoder (whose tables the
state holds in the JAX package's feature-major layout); a JAX system's
state() through numpy, loaded into the port, gives the same next step;
AsyncCkptManager commits each step atomically, keeps max_to_keep steps
and finds the latest; fit resumes from its steps/ directory, writes the
validation images every VAL_DUMP_EVERY steps, draws from the native
sampler when asked (and raises where it cannot) and writes a profile
into profile_dir."""
import json
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ingp_tpu.data.synthetic import SyntheticDataset as JData
from ingp_tpu.training import trainer as jt
from ingp_tpu_torch.data.image_io import read_png
from ingp_tpu_torch.data.synthetic import SyntheticDataset
from ingp_tpu_torch.training import trainer as tt
from ingp_tpu_torch.utils import ckpt
from tests.test_torch_train import _adam_moments, _leaf_close
from tests._torch_threads import one_torch_thread  # noqa: F401


def _hparams(**kw):
    """bench.py's training configuration at a tiny size."""
    h = dict(dataset_name="synthetic", root_dir="", split="train",
             downsample=1.0, scale=0.5, use_skybox=False, use_exposure=False,
             embed_a=False, embed_a_len=4, embed_msk=False, num_classes=7,
             batch_size=128, ray_sampling_strategy="all_images",
             num_epochs=2, normal_epochs=0, steps_per_epoch=2, lr=1e-2,
             density_threshold=1e-2, depth_mono=False, normal_mono=False,
             normal_ref=True, optimize_ext=False, random_bg=False,
             render_semantic=False, chunk_size=2048, seed=0, ckpt_load=None,
             compute_dtype="float32", table_dtype="float32", capacity=16,
             march_iters=64, samples_per_ray=8, encoder="brick",
             encode_chunk=1024, stream_dedup=True, stream_tile=256,
             stream_seg=4, stream_slack=1.5, stream_direct_frac=0.7,
             stream_sort=True, stream_head_frac=0.0, density_L=2, rgb_L=2,
             density_log2T=10, rgb_log2T=10, grid_size=16, logger="jsonl",
             exp_name="t")
    h.update(kw)
    return SimpleNamespace(**h)


def _system(h, **kw):
    tr = SyntheticDataset(split="train", img_size=8, n_train=2)
    return tt.NeRFSystem(h, tr, device="cpu", **kw)


def _equal_trees(a, b):
    la, lb = tt.tree_leaves(a), tt.tree_leaves(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        x, y = np.asarray(x), np.asarray(y)
        assert x.shape == y.shape and x.dtype == y.dtype, path
        np.testing.assert_array_equal(x, y, err_msg=str(path))


@pytest.mark.parametrize("encoder", ["brick", "hash"])
def test_save_load_round_trip(tmp_path, encoder):
    h = _hparams(encoder=encoder)
    a = _system(h)
    rng = np.random.default_rng(1)
    for _ in range(2):
        a.training_step(a.train_dataset.sample_batch(rng))
    st = a.state()
    assert st["step"] == 2 and st["opt_state"]["count"] == 2
    table = st["params"]["model"]["density_table"]
    if encoder == "hash":    # the JAX package's (F, total_rows) layout
        assert table.shape == (8, a.model_cfg.density_grid_cfg.total_rows)
    assert np.abs(st["opt_state"]["mu"]["model"]["density_table"]).max() > 0
    path = tmp_path / "full"
    a.save(path)
    b = _system(h, seed=7)
    b.load(path)
    got = b.state()
    _equal_trees(got["params"], st["params"])
    _equal_trees(got["opt_state"], st["opt_state"])
    _equal_trees(got["grid"], st["grid"])
    assert got["step"] == 2 and b.global_step == 2
    # both take the same next step
    batch = a.train_dataset.sample_batch(rng)
    batch["noise"] = rng.random(len(batch["pix_idxs"]), dtype=np.float32)
    assert float(a.train_step(batch)["loss"]) == float(
        b.train_step(batch)["loss"])
    _equal_trees(b.params_to_numpy(), a.params_to_numpy())
    # a slim checkpoint: the weights and the step, the grid untouched
    ckpt.save_ckpt(tmp_path / "slim", ckpt.slim_state(st))
    slim = ckpt.load_ckpt(tmp_path / "slim")
    assert set(slim) == {"params", "step"}
    c = _system(h, seed=9)
    grid0 = {k: v.clone() for k, v in c.grid.items()}
    c.load(tmp_path / "slim")
    _equal_trees(c.params_to_numpy(), st["params"])
    assert all(torch.equal(grid0[k], c.grid[k]) for k in grid0)
    np.testing.assert_array_equal(
        ckpt.extract_model_state(slim)["xyz_net"][0]["w"],
        st["params"]["model"]["xyz_net"][0]["w"])
    # hparams.ckpt_load is loaded by the constructor
    d = _system(_hparams(encoder=encoder, ckpt_load=str(path)))
    _equal_trees(d.state()["params"], st["params"])
    assert d.global_step == 2


def test_jax_state_loads_into_port():
    """A JAX system's state after one step (hash encoder, f32), through
    numpy, gives the port the JAX system's next step: the loss to rtol
    1e-5 and the parameters after it to 1e-3 of each leaf's largest
    value (test_torch_train.py's bounds)."""
    h = _hparams(encoder="hash", stream_dedup=False, density_L=4, rgb_L=4,
                 density_log2T=12, rgb_log2T=12, grid_size=32,
                 batch_size=256, capacity=48, samples_per_ray=16,
                 march_iters=256, num_epochs=20, steps_per_epoch=1000)
    jsys = jt.NeRFSystem(h, JData(split="train", img_size=24, n_train=4))
    # tables scaled up so that the encoders' features matter
    params = jax.tree.map(np.asarray, jsys.params)
    params["model"]["density_table"] = params["model"]["density_table"] * 1e4
    params["model"]["rgb_table"] = params["model"]["rgb_table"] * 1e3
    jsys.params = jax.tree.map(jnp.asarray, params)
    jsys.opt_state = jsys.tx.init(jsys.params)
    rng = np.random.default_rng(0)
    tr = SyntheticDataset(split="train", img_size=24, n_train=4)
    batches = []
    for _ in range(2):
        b = tr.sample_batch(rng, 256)
        b["noise"] = rng.random(256, dtype=np.float32)
        batches.append(b)
    jsys.training_step(batches[0])
    st = jax.tree.map(np.asarray, jsys.state())
    mu, nu = _adam_moments(st["opt_state"])
    state = {"params": st["params"],
             "opt_state": {"mu": mu, "nu": nu, "count": int(st["step"])},
             "grid": st["grid"], "step": int(st["step"])}
    psys = tt.NeRFSystem(h, tr, device="cpu", seed=5)
    psys.load_state(state)
    assert psys.global_step == 1
    assert psys.grid["bitfield"].dtype == torch.int32
    aux_j = jsys.training_step(batches[1])
    aux_t = psys.training_step(batches[1])
    np.testing.assert_allclose(float(aux_t["loss"]), float(aux_j["loss"]),
                               rtol=1e-5)
    _leaf_close(psys.params_to_numpy(), jax.tree.map(np.asarray,
                                                     jsys.params),
                1e-3, "param")
    assert psys.global_step == 2


def test_async_manager_commit_cleanup_latest(tmp_path, monkeypatch):
    root = tmp_path / "steps"
    os.makedirs(root / ".tmp-killed")      # a write that a kill cut short
    mgr = ckpt.AsyncCkptManager(root, max_to_keep=2)
    assert not (root / ".tmp-killed").exists()
    assert mgr.latest_step() is None and mgr.restore() is None
    live = torch.zeros(3)
    for step in (1, 2, 3):
        live.fill_(step)
        mgr.save(step, {"x": live, "n": np.full(2, step, np.int32),
                        "step": step})
    live.fill_(-1)      # the saves snapshotted the state when called
    mgr.wait()
    assert mgr.steps() == [2, 3] and mgr.latest_step() == 3
    got = mgr.restore()
    assert got["step"] == 3 and torch.equal(got["x"], torch.full((3,), 3.0))
    assert torch.equal(mgr.restore(2)["n"], torch.full((2,), 2,
                                                       dtype=torch.int32))
    # a failed write commits nothing, leaves no temporary, and raises on
    # the next wait
    real = ckpt.torch.save

    def broken(obj, f):
        real(obj, f)
        raise OSError("disk full")
    monkeypatch.setattr(ckpt.torch, "save", broken)
    mgr.save(4, {"step": 4})
    with pytest.raises(OSError, match="disk full"):
        mgr.wait()
    assert mgr.steps() == [2, 3]
    assert sorted(os.listdir(root)) == ["2", "3"]
    with pytest.raises(OSError):
        ckpt.save_ckpt(tmp_path / "one", {"step": 1})
    assert not (tmp_path / "one").exists()
    assert not [n for n in os.listdir(tmp_path) if n.startswith(".tmp-")]
    monkeypatch.setattr(ckpt.torch, "save", real)
    mgr.close()


def test_fit_checkpoints_resume_and_refusals(tmp_path, monkeypatch):
    h = _hparams()
    a = _system(h)
    a.fit(log_every=1, ckpt_dir=str(tmp_path))
    assert a.global_step == 4
    assert sorted(os.listdir(tmp_path / "steps")) == ["2", "4"]
    for name in ("last", "last_slim", "metrics.jsonl"):
        assert (tmp_path / name).is_file()
    lines = (tmp_path / "metrics.jsonl").read_text().splitlines()
    assert len(lines) == 4 and '"train/psnr"' in lines[0]
    # a cold start on the same directory resumes at the latest step
    b = _system(h, seed=3)
    b.fit(ckpt_dir=str(tmp_path))
    assert b.global_step == 4
    _equal_trees(b.params_to_numpy(), a.params_to_numpy())
    # ... unless told not to: then it trains from step 0
    c = _system(_hparams(no_resume=True, num_epochs=1))
    steps = []
    c.fit(ckpt_dir=str(tmp_path / "fresh"),
          on_step=lambda s, aux: steps.append(s))
    assert steps == [0, 1]
    # use_native_loader=True is the default's sampler (the native one);
    # a dataset whose layout it cannot read raises instead of falling
    # back to numpy
    one = _system(_hparams(num_epochs=1)).fit(use_native_loader=True)
    two = _system(_hparams(num_epochs=1)).fit()
    _equal_trees(one.params_to_numpy(), two.params_to_numpy())
    bad = _system(_hparams(num_epochs=1))
    bad.train_dataset.rays = bad.train_dataset.rays[:, :10]
    with pytest.raises(ValueError, match="rays"):
        bad.fit(use_native_loader=True)
    # the validation images at every VAL_DUMP_EVERY steps after step 0
    monkeypatch.setattr(tt, "VAL_DUMP_EVERY", 2)
    te = SyntheticDataset(split="test", img_size=8, n_test=1)
    _system(_hparams(num_epochs=3), test_dataset=te).fit(
        ckpt_dir=str(tmp_path / "long"))
    dumps = sorted(os.listdir(tmp_path / "long" / "val"))
    assert dumps == [f"{s:05d}_{k}.png" for s in (2, 4)
                     for k in ("depth", "normal", "normal_raw", "rgb")]
    for name in dumps:
        assert read_png(tmp_path / "long" / "val" / name).shape == (8, 8, 3)
    # profile_dir: a Chrome trace of the window's steps, one
    # "train_step" range each
    monkeypatch.setattr(tt, "PROFILE_STEPS", (1, 3))
    _system(_hparams(profile_dir=str(tmp_path / "prof"))).fit()
    events = json.loads((tmp_path / "prof" / "trace.json").read_text())[
        "traceEvents"]
    assert sum(e.get("name") == "train_step"
               and e.get("cat") == "user_annotation" for e in events) == 2
