"""The port's trainer reads every hparam the JAX trainer reads, or refuses
it: `seed` seeds the port's generator (an explicit `seed=` still wins),
`ckpt_load` loads its checkpoint, and `stream_autocal`, `eval_lpips`,
`stream_head_frac` and the `fused` encoder, which the port has not
ported, raise NotImplementedError instead of being dropped; so do the
CLI flags that `ingp_tpu_torch.train.main` cannot honour yet."""
from types import SimpleNamespace

import pytest
import torch

from ingp_tpu_torch import train as train_cli
from ingp_tpu_torch.data.synthetic import SyntheticDataset
from ingp_tpu_torch.training import trainer as tt
from ingp_tpu_torch.training.trainer import tree_leaves


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
                                    "fused"])
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
    kw = {"encoder": "fused"} if hparam == "fused" else \
        {hparam: 0.5 if hparam == "stream_head_frac" else True}
    with pytest.raises(NotImplementedError, match=hparam):
        _params(_hparams(**kw))


# flags of the CLI that `train.main` refuses at its start, with what they
# would do in the JAX entry point
CLI_REFUSED = {
    "save_test": ([], "offline test render"),
    "distributed": (["--no_save_test", "--distributed"], "distributed"),
    "coordinator_address": (["--no_save_test", "--coordinator_address",
                             "localhost:1"], "coordinator_address"),
    "num_gpus": (["--no_save_test", "--num_gpus", "2"], "num_gpus"),
    "debug_nans": (["--no_save_test", "--debug_nans"], "debug_nans"),
}


@pytest.mark.parametrize("flag", list(CLI_REFUSED))
def test_cli_flag_refused(flag, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    argv, match = CLI_REFUSED[flag]
    with pytest.raises(NotImplementedError, match=match):
        train_cli.main(["--dataset_name", "synthetic"] + argv,
                       device="cpu")
    assert not (tmp_path / "ckpts").exists()
    with pytest.raises(ValueError, match="ckpt_load"):
        train_cli.main(["--val_only"], device="cpu")
