"""The port's LPIPS (ingp_tpu_torch/training/lpips.py, metrics.lpips,
utils/export_lpips.py, NeRFSystem.validate with eval_lpips) against the
JAX package's, with random weights of the production shapes (the
pretrained file is not in the repository): the distance of one pair and
of a batch within rtol 1e-5, the npz round trip and its bad-file error,
the metrics wrapper, a validate with eval_lpips on a tiny synthetic
scene, and the exporter's npz equal to the JAX exporter's from the same
AlexNet and LPIPS head tensors."""
import sys
from types import SimpleNamespace

import numpy as np
import jax
import pytest
import torch

from ingp_tpu.training import lpips as jl
from ingp_tpu.training import metrics as jm
from ingp_tpu_torch.core import prng
from ingp_tpu_torch.training import lpips as tl
from ingp_tpu_torch.training import metrics as tm
from tests._torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def jparams():
    return {k: np.asarray(v) for k, v in
            jl.random_lpips_params(jax.random.PRNGKey(0)).items()}


def _imgs(seed, shape=(64, 64, 3)):
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


def test_random_params_are_jax_draws(jparams):
    mine = tl.random_lpips_params(prng.prng_key(0), device="cpu")
    ref = tl.params_from_numpy(jparams)
    for k in tl.EXPECTED_KEYS:
        assert mine[k].shape == ref[k].shape, k
        # the same uniforms; torch's float32 erfinv is a few ulps from
        # XLA's (measured 5.5e-6 relative at most)
        np.testing.assert_allclose(mine[k].numpy(), ref[k].numpy(),
                                   rtol=1e-5, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("shape", [(64, 64, 3), (3, 72, 56, 3)])
def test_lpips_matches_jax(jparams, shape):
    a, b = _imgs(1, shape), _imgs(2, shape)
    want = np.asarray(jl.lpips(jparams, a, b))
    got = tl.lpips(tl.params_from_numpy(jparams), a, b)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    # identical images are at distance 0 and the distance is symmetric
    assert float(tl.lpips(tl.params_from_numpy(jparams), a, a).max()) \
        == pytest.approx(0.0, abs=1e-6)
    np.testing.assert_allclose(
        tl.lpips(tl.params_from_numpy(jparams), b, a).numpy(), want,
        rtol=1e-5)


def test_lpips_keeps_full_float32_under_tf32(jparams, monkeypatch):
    """The cuDNN TF32 switch is off inside lpips and restored after it."""
    seen = []
    conv = torch.nn.functional.conv2d

    def spy(*a, **k):
        seen.append(torch.backends.cudnn.allow_tf32)
        return conv(*a, **k)

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(tl.nnf, "conv2d", spy)
    tl.lpips(tl.params_from_numpy(jparams), _imgs(3), _imgs(4))
    assert seen == [False] * 10
    assert torch.backends.cudnn.allow_tf32 is True


def test_npz_round_trip_and_bad_file(jparams, tmp_path):
    path = tmp_path / "w.npz"
    np.savez(path, **jparams)
    loaded = tl.load_lpips(path, "cpu")
    assert set(loaded) == set(tl.EXPECTED_KEYS)
    assert tuple(loaded["conv0_w"].shape) == (64, 3, 11, 11)   # OIHW
    a, b = _imgs(5), _imgs(6)
    np.testing.assert_allclose(
        float(tl.lpips(loaded, a, b)),
        float(jl.lpips(jl.load_lpips(path), a, b)), rtol=1e-5)
    tl.save_lpips(tmp_path / "again.npz", loaded)
    again = np.load(tmp_path / "again.npz")
    for k in tl.EXPECTED_KEYS:
        np.testing.assert_array_equal(again[k], jparams[k])
    bad = tmp_path / "bad.npz"
    np.savez(bad, conv0_w=np.zeros(3))
    with pytest.raises(ValueError, match="ingp_tpu_torch.utils.export_lpips"):
        tl.load_lpips(bad, "cpu")


def test_metrics_wrapper(jparams, tmp_path, monkeypatch):
    path = tmp_path / "w.npz"
    np.savez(path, **jparams)
    a, b = _imgs(7), _imgs(8)
    want = float(jm.lpips(a, b, weights_path=str(path)))
    assert float(tm.lpips(torch.from_numpy(a), torch.from_numpy(b),
                          weights_path=str(path))) == pytest.approx(
        want, rel=1e-5)
    assert float(tm.lpips(a, b, params=tl.params_from_numpy(jparams))) \
        == pytest.approx(want, rel=1e-5)
    for mod, exc in ((jm, RuntimeError), (tm, RuntimeError)):
        with pytest.raises(exc, match="--lpips_weights"):
            mod.lpips(a, b)
    # arrays, and the entry points' default, go to the card: with none
    # visible they raise rather than run on the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: tm.lpips(a, b, weights_path=str(path)),
                 lambda: tl.load_lpips(path),
                 lambda: tl.random_lpips_params(prng.prng_key(0))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def _hparams(**kw):
    h = dict(dataset_name="synthetic", root_dir="", split="train",
             downsample=1.0, scale=0.5, use_skybox=False, use_exposure=False,
             embed_a=False, embed_a_len=4, embed_msk=False, num_classes=4,
             batch_size=256, ray_sampling_strategy="all_images",
             num_epochs=1, normal_epochs=0, steps_per_epoch=10, lr=1e-2,
             density_threshold=1e-2, depth_mono=False, normal_mono=False,
             normal_ref=False, optimize_ext=False, random_bg=False,
             render_semantic=False, chunk_size=2048, seed=0,
             ckpt_load=None, compute_dtype="float32", capacity=16,
             march_iters=128, samples_per_ray=16, grid_size=32,
             density_L=4, density_F=2, density_log2T=12, rgb_L=4,
             rgb_F=2, rgb_log2T=12, logger="none", exp_name="t")
    h.update(kw)
    return SimpleNamespace(**h)


def test_validate_with_lpips_matches_jax(jparams, tmp_path):
    """JAX's validate and the port's, from the same parameters, on two
    40 px test views (AlexNet's trunk needs 31 px or more)."""
    import jax.numpy as jnp
    from ingp_tpu.data.synthetic import SyntheticDataset as JData
    from ingp_tpu.training.trainer import NeRFSystem as JSystem
    from ingp_tpu_torch.data.synthetic import SyntheticDataset
    from ingp_tpu_torch.training.trainer import NeRFSystem
    path = tmp_path / "w.npz"
    np.savez(path, **jparams)
    h = _hparams(eval_lpips=True, lpips_weights=str(path))
    jsys = JSystem(h, JData(split="train", img_size=40, n_train=2),
                   JData(split="test", img_size=40, n_test=2))
    params = jax.tree.map(lambda a: np.array(a, np.float32), jsys.params)
    for k in ("density_table", "rgb_table"):
        params["model"][k] *= np.float32(1e3)
    jsys.params = jax.tree.map(jnp.asarray, params)
    want = jsys.validate()
    tsys = NeRFSystem(h, SyntheticDataset(split="train", img_size=40,
                                          n_train=2),
                      SyntheticDataset(split="test", img_size=40, n_test=2),
                      device="cpu", params=params)
    got = tsys.validate()
    assert set(got) == set(want) == {"psnr", "ssim", "lpips"}
    assert got["lpips"] > 0
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-4), k
    # without the flag the metric is absent, as in JAX
    tsys.hparams = _hparams()
    assert set(tsys.validate()) == {"psnr", "ssim"}


# AlexNet's `features` (torchvision): conv, relu, pool, ...
_TRUNK = ((3, 64, 11, 4, 2), (64, 192, 5, 1, 2), (192, 384, 3, 1, 1),
          (384, 256, 3, 1, 1), (256, 256, 3, 1, 1))


def _fake_alexnet():
    torch.manual_seed(0)
    c = [torch.nn.Conv2d(i, o, k, s, p) for i, o, k, s, p in _TRUNK]
    r, pool = torch.nn.ReLU, lambda: torch.nn.MaxPool2d(3, 2)
    net = torch.nn.Module()
    net.features = torch.nn.Sequential(c[0], r(), pool(), c[1], r(), pool(),
                                       c[2], r(), c[3], r(), c[4], r(),
                                       pool())
    return net


def test_export_matches_jax_exporter(tmp_path, monkeypatch):
    from ingp_tpu.utils import export_lpips as jexport
    from ingp_tpu_torch.utils import export_lpips as texport
    net = _fake_alexnet()
    models = SimpleNamespace(alexnet=lambda weights=None: net,
                             AlexNet_Weights=SimpleNamespace(
                                 IMAGENET1K_V1="IMAGENET1K_V1"))
    monkeypatch.setitem(sys.modules, "torchvision",
                        SimpleNamespace(models=models))
    monkeypatch.setitem(sys.modules, "torchvision.models", models)
    g = torch.Generator().manual_seed(1)
    lins = {f"lin{i}.model.1.weight": torch.rand((1, c[1], 1, 1),
                                                 generator=g)
            for i, c in enumerate(_TRUNK)}
    torch.save(lins, tmp_path / "alex.pth")
    torch.save(net.state_dict(), tmp_path / "alexnet.pth")
    jexport.export(str(tmp_path / "jax.npz"), str(tmp_path / "alex.pth"))
    texport.export(str(tmp_path / "port.npz"), str(tmp_path / "alexnet.pth"),
                   str(tmp_path / "alex.pth"))
    want, got = np.load(tmp_path / "jax.npz"), np.load(tmp_path / "port.npz")
    assert sorted(got.files) == sorted(want.files) == sorted(tl.EXPECTED_KEYS)
    for k in want.files:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # and both packages read it to the same distance
    a, b = _imgs(9), _imgs(10)
    np.testing.assert_allclose(
        float(tl.lpips(tl.load_lpips(tmp_path / "port.npz", "cpu"), a, b)),
        float(jl.lpips(jl.load_lpips(tmp_path / "jax.npz"), a, b)),
        rtol=1e-5)
