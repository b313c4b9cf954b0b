"""The port's trainer reads every hparam the JAX trainer reads, or refuses
it: `seed` seeds the port's generator (an explicit `seed=` still wins),
and `stream_autocal`, `ckpt_load` and `eval_lpips`, which the port has
not ported, raise NotImplementedError instead of being dropped."""
from types import SimpleNamespace

import pytest
import torch

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
                                    "eval_lpips", "seed"])
def test_hparam_honoured_or_refused(hparam):
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
    value = "ckpts/missing.ckpt" if hparam == "ckpt_load" else True
    with pytest.raises(NotImplementedError, match=hparam):
        _params(_hparams(**{hparam: value}))
