"""The port's trainer reads every hparam the JAX trainer reads, or refuses
it: `seed` seeds the port's generator (an explicit `seed=` still wins),
`ckpt_load` loads its checkpoint, `optimize_ext` adds the pose
corrections and their optimiser group, `stream_autocal`,
`stream_head_frac` and the `fused` encoder reach the configs and a step
runs with each, and `eval_lpips`, which the port has not ported, raises
NotImplementedError instead of being dropped, and so does a dataset's
per-ray exposure (JAX's own step fails on it); the CLI flags that
`ingp_tpu_torch.train.main` once refused (--distributed,
--coordinator_address, --num_gpus 2 (two spawned gloo ranks),
--debug_nans) run. The model
features `embed_a`, `embed_msk`, `random_bg`, `use_skybox` and
`use_exposure` are honoured: each changes the parameters or the step."""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from ingp_tpu_torch import train as train_cli
from ingp_tpu_torch.data.synthetic import SyntheticDataset, \
    sphere_density_grid
from ingp_tpu_torch.grid.occupancy import grid_from_density
from ingp_tpu_torch.training import trainer as tt
from ingp_tpu_torch.training.trainer import tree_leaves
from tests._torch_threads import one_torch_thread  # noqa: F401


def _hparams(**kw):
    """bench.py's training configuration at a tiny size."""
    h = dict(dataset_name="synthetic", root_dir="", split="train",
             downsample=1.0, scale=0.5, use_skybox=False, use_exposure=False,
             embed_a=False, embed_a_len=4, embed_msk=False, num_classes=7,
             batch_size=256, ray_sampling_strategy="all_images",
             num_epochs=1, normal_epochs=0, steps_per_epoch=10, lr=1e-2,
             density_threshold=1e-2, depth_mono=False, normal_mono=False,
             normal_ref=True, optimize_ext=False, random_bg=False,
             render_semantic=False, chunk_size=2048, seed=0, ckpt_load=None,
             compute_dtype="float32", table_dtype="float32", capacity=16,
             march_iters=64, samples_per_ray=8, encoder="brick",
             encode_chunk=2048, stream_dedup=True, stream_tile=256,
             stream_seg=4, stream_slack=1.5, stream_direct_frac=0.7,
             stream_sort=True, stream_head_frac=0.0, density_L=2, rgb_L=2,
             density_log2T=10, rgb_log2T=10, grid_size=16)
    h.update(kw)
    return SimpleNamespace(**h)


def _params(h, **kw):
    tr = SyntheticDataset(split="train", img_size=8, n_train=2)
    system = tt.NeRFSystem(h, tr, device="cpu", **kw)
    return [t.detach().clone() for _, t in tree_leaves(system.params)]


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("hparam", ["stream_autocal", "ckpt_load",
                                    "eval_lpips", "seed", "stream_head_frac",
                                    "fused", "optimize_ext"])
def test_hparam_honoured_or_refused(hparam, tmp_path):
    if hparam == "seed":
        one, two = _params(_hparams(seed=1)), _params(_hparams(seed=2))
        assert not _same(one, two)
        assert _same(one, _params(_hparams(seed=1)))
        # an explicit seed= wins over hparams.seed
        assert _same(two, _params(_hparams(seed=1), seed=2))
        # a namespace without seed seeds with 0
        h = _hparams()
        del h.seed
        assert _same(_params(h), _params(_hparams(seed=0)))
        return
    if hparam == "ckpt_load":
        tr = SyntheticDataset(split="train", img_size=8, n_train=2)
        saved = tt.NeRFSystem(_hparams(seed=4), tr, device="cpu")
        saved.global_step = 7
        saved.save(tmp_path / "ckpt")
        h = _hparams(ckpt_load=str(tmp_path / "ckpt"))
        loaded = tt.NeRFSystem(h, tr, device="cpu")
        assert loaded.global_step == 7
        assert _same(_params(h), [t.detach() for _, t in
                                  tree_leaves(saved.params)])
        assert not _same(_params(h), _params(_hparams()))
        return
    if hparam == "optimize_ext":
        # honoured: zero corrections per image in their own Adam group at
        # 1e-6, moved by a step
        tr = SyntheticDataset(split="train", img_size=8, n_train=2)
        system = tt.NeRFSystem(_hparams(optimize_ext=True), tr,
                               device="cpu")
        ext = system.params["ext"]
        assert {k: tuple(v.shape) for k, v in ext.items()} == {
            "dR": (2, 3), "dT": (2, 3)}
        assert not any(v.any() for v in ext.values())
        assert [g["lr"] for g in system.optimizer.param_groups][1] == 1e-6
        system.training_step(tr.sample_batch(np.random.default_rng(0), 256))
        assert all(v.abs().max() > 0 for v in ext.values())
        assert "ext" not in tt.NeRFSystem(_hparams(), tr,
                                          device="cpu").params
        return
    if hparam == "eval_lpips":
        with pytest.raises(NotImplementedError, match=hparam):
            _params(_hparams(eval_lpips=True))
        return
    # honoured: each reaches the configs, and a step runs with it
    kw = {"encoder": "fused"} if hparam == "fused" else \
        {hparam: 0.5 if hparam == "stream_head_frac" else True}
    tr = SyntheticDataset(split="train", img_size=8, n_train=2)
    system = tt.NeRFSystem(_hparams(**kw), tr, device="cpu")
    if hparam == "fused":
        assert set(system.params["model"]) >= {"grid_table"}
        assert "density_table" not in system.params["model"]
    elif hparam == "stream_head_frac":
        assert system.model_cfg.stream_head_frac == 0.5
    else:
        assert system.render_cfg.run_stats
    aux = system.training_step(tr.sample_batch(np.random.default_rng(0),
                                               256))
    assert np.isfinite(float(aux["loss"]))


# flags of the CLI that `train.main` once refused; each now runs: a
# world of one process where no group of more ranks is named (as in the
# JAX entry point), two spawned ranks for --num_gpus 2
CLI_REFUSED = {
    "distributed": ["--distributed"],
    "coordinator_address": ["--coordinator_address", "file://{tmp}/store",
                            "--num_processes", "1", "--process_id", "0"],
    "num_gpus": ["--num_gpus", "2"],
    "debug_nans": ["--debug_nans"],
}
TINY_CLI = ["--dataset_name", "synthetic", "--num_epochs", "1",
            "--normal_epochs", "0", "--steps_per_epoch", "2",
            "--batch_size", "128", "--downsample", "0.125", "--capacity",
            "8", "--samples_per_ray", "8", "--march_iters", "64",
            "--grid_size", "16", "--density_L", "2", "--rgb_L", "2",
            "--density_log2T", "10", "--rgb_log2T", "10", "--no_save_test"]


@pytest.mark.parametrize("flag", list(CLI_REFUSED))
def test_cli_flag_refused(flag, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    argv = [a.format(tmp=tmp_path) for a in CLI_REFUSED[flag]]
    m = train_cli.main(TINY_CLI + argv, device="cpu")
    assert np.isfinite(m["psnr"]) and 0 < m["ssim"] <= 1
    assert (tmp_path / "ckpts" / "synthetic" / "exp" / "last").is_file()
    with pytest.raises(ValueError, match="ckpt_load"):
        train_cli.main(["--val_only"], device="cpu")


def _system(h, tr=None):
    """A tiny system on the grid of the scene's spheres, its tables
    scaled up so that the field is not empty."""
    tr = tr or SyntheticDataset(split="train", img_size=8, n_train=2)
    system = tt.NeRFSystem(h, tr, device="cpu")
    cfg = system.model_cfg
    dg = torch.as_tensor(sphere_density_grid(cfg.grid_size, cfg.cascades,
                                             cfg.scale))
    system.grid = grid_from_density(system.grid, dg, 0.5, cfg.grid_size,
                                    cfg.cascades)
    with torch.no_grad():
        for k in ("density_table", "rgb_table"):
            system.params["model"][k].mul_(1e4)
    return system


def _step_loss(system, batch, step=0, bg_color=None):
    system.global_step = step
    aux, grads = system.loss_and_grads(batch, batch["noise"],
                                       bg_color=bg_color)
    return float(aux["loss"]), grads


@pytest.mark.parametrize("feature", ["embed_a", "embed_msk", "random_bg",
                                     "use_skybox", "use_exposure"])
def test_feature_honoured(feature):
    """The feature's parameters exist and take a gradient, or its
    background changes the step's loss, where it is on and not off."""
    # a lattice long enough to reach the spheres
    on = _system(_hparams(march_iters=1024, **{feature: True}))
    off = _system(_hparams(march_iters=1024))
    rng = np.random.default_rng(0)
    batch = on.train_dataset.sample_batch(rng, 64)
    batch["noise"] = rng.random(64, dtype=np.float32)
    assert _step_loss(off, batch)[0] > 0 and \
        float(off.loss_and_grads(batch, batch["noise"])[0]["s_per_ray"]) > 0
    if feature == "embed_a":
        assert on.model_cfg.rgb_in_dim == off.model_cfg.rgb_in_dim + 4
        _, g = _step_loss(on, batch)
        assert g["embedding_a"].abs().max() > 0
    if feature == "embed_msk":
        assert "msk" in on.params and "msk" not in off.params
        _, g = _step_loss(on, batch)
        assert g["msk"]["table"].abs().max() > 0
        assert g["msk"]["net"][0]["w"].abs().max() > 0
    if feature == "random_bg":
        bg = on.step_draws(64)["bg_color"]
        assert bg.shape == (3,) and "bg_color" not in off.step_draws(64)
        base = _step_loss(on, batch, bg_color=torch.zeros(3))[0]
        assert _step_loss(on, batch)[0] != base
        assert _step_loss(off, batch)[0] == base
    if feature == "use_skybox":
        closed, _ = _step_loss(on, batch)
        assert closed == _step_loss(off, batch)[0]
        opened, g = _step_loss(on, batch, on.WARMUP_STEPS)
        assert opened != closed
        assert g["model"]["skybox_net"][0]["w"].abs().max() > 0
    if feature == "use_exposure":
        assert on.model_cfg.rgb_act == "none"
        _, g = _step_loss(on, batch)
        assert g["model"]["tonemapper_r"][0]["w"].abs().max() > 0


def test_per_ray_exposure_refused():
    tr = SyntheticDataset(split="train", img_size=8, n_train=2)
    tr.rays = np.concatenate([tr.rays, np.ones_like(tr.rays[..., :1])], -1)
    system = _system(_hparams(use_exposure=True, march_iters=1024), tr)
    batch = tr.sample_batch(np.random.default_rng(0), 64)
    assert batch["exposure"].shape == (64, 1)
    with pytest.raises(NotImplementedError, match="per-ray exposure"):
        system.train_step(batch)
