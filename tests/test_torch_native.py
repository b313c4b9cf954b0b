"""The port's native batch sampler (ingp_tpu_torch/native) against the
JAX package's (ingp_tpu/native), and the sampler `fit` draws from.

- The two samplers give bitwise equal batches, every key, at seeds 7
  and 123 over 5 batches, for both ray sampling strategies; batch n
  depends on (seed, n) alone (a second sampler repeats the stream).
- `fit` takes the sampler JAX's `fit` takes (JAX: the native one
  wherever its constructor accepts the dataset) on the synthetic, NSVF,
  KITTI-360 and Mega-NeRF fixtures the port writes, and its first batch
  equals the JAX sampler's on JAX's loader of the same files; a layout
  the constructor refuses falls back to numpy with JAX's line, or raises
  with use_native_loader=True.
- Two f32 steps of JAX's `fit()` and of the port's `fit()` at their
  defaults draw the same batches: the losses agree to rtol 1e-5.
"""
import subprocess
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ingp_tpu.data import dataset_dict as jax_datasets
from ingp_tpu.data.synthetic import SyntheticDataset as JData
from ingp_tpu.native import NativeBatchSampler as JSampler
from ingp_tpu.training import trainer as jt
from ingp_tpu_torch.data import dataset_dict
from ingp_tpu_torch.data.synthetic import SyntheticDataset
from ingp_tpu_torch.native import NativeBatchSampler
from ingp_tpu_torch.training import trainer as tt
from ingp_tpu_torch.utils.blender_fixture import write_nsvf_scene
from ingp_tpu_torch.utils.mega_fixture import write_mega_scene
from ingp_tpu_torch.utils.street_fixture import write_kitti_scene
from tests._torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module", autouse=True)
def jax_sampler_library(tmp_path_factory):
    """The JAX sampler's library built from its own source into a
    directory of this module's: JAX builds it in place inside its package
    (ingp_tpu/native/build.py), which another test process may be doing
    at the same moment; a half-written library would make the JAX side
    of these tests unavailable."""
    import ingp_tpu.native.build as jbuild
    import ingp_tpu.native.loader as jloader
    out = tmp_path_factory.mktemp("jax_native") / "_dataloader.so"
    subprocess.run(["g++", "-O3", "-std=c++17", "-shared", "-fPIC",
                    "-pthread", jbuild._SRC, "-o", str(out)], check=True,
                   capture_output=True, timeout=120)
    saved = jloader._LIB
    jloader._LIB = None
    real = jbuild.build_library
    jbuild.build_library = lambda force=False: str(out)
    try:
        assert jloader.native_available()
        yield
    finally:
        jbuild.build_library = real
        jloader._LIB = saved


def _equal_batches(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("strategy", ["all_images", "same_image"])
@pytest.mark.parametrize("seed", [7, 123])
def test_native_sampler_matches_jax(seed, strategy):
    ds = SyntheticDataset(split="train", img_size=24, n_train=5)
    with NativeBatchSampler(ds, 300, seed=seed, strategy=strategy) as got, \
            NativeBatchSampler(ds, 300, seed=seed, strategy=strategy) as again:
        ref = JSampler(ds, 300, seed=seed, strategy=strategy)
        try:
            for _ in range(5):
                b = got.next_batch()
                _equal_batches(b, ref.next_batch())
                _equal_batches(b, again.next_batch())
        finally:
            ref.close()
    assert sorted(b) == ["img_idxs", "label", "normal", "pix_idxs", "rgb",
                         "uv"]
    if strategy == "same_image":
        assert len(set(b["img_idxs"].tolist())) == 1
    # the same keys as the numpy sampler's, with its dtypes
    ref = ds.sample_batch(np.random.default_rng(0), 300, strategy)
    assert {k: v.dtype for k, v in b.items()} == \
        {k: v.dtype for k, v in ref.items()}


def _tiny(**kw):
    h = dict(dataset_name="synthetic", root_dir="", split="train",
             downsample=1.0, scale=0.5, use_skybox=False, use_exposure=False,
             embed_a=False, embed_a_len=4, embed_msk=False, num_classes=7,
             batch_size=256, ray_sampling_strategy="all_images",
             num_epochs=1, normal_epochs=0, steps_per_epoch=2, lr=1e-2,
             density_threshold=1e-2, depth_mono=False, normal_mono=False,
             normal_ref=False, optimize_ext=False, random_bg=False,
             render_semantic=False, chunk_size=2048, seed=5, ckpt_load=None,
             compute_dtype="float32", capacity=16, march_iters=128,
             samples_per_ray=16, grid_size=32, density_L=4, density_F=2,
             density_log2T=12, rgb_L=4, rgb_F=2, rgb_log2T=12)
    h.update(kw)
    return SimpleNamespace(**h)


def _fixture(name, root):
    """(loader kwargs) of a small fixture of dataset `name` under root."""
    if name == "nsvf":
        ds = write_nsvf_scene(str(root / "Synthetic_NeRF" / "Lego"),
                              img_size=16, n_train=3, n_test=1)
        # the downsample that reads the frames at their own size
        return dict(root_dir=str(root / "Synthetic_NeRF" / "Lego"),
                    downsample=ds)
    if name == "kitti":
        write_kitti_scene(str(root / "k"), frames=range(2, 6),
                          img_wh=(44, 12))
        # at downsample 0.5 the loader keeps the normals at the files'
        # size (a fault of the reference): JAX's sampler reads them at the
        # resized image's stride, and so does the port's
        return dict(root_dir=str(root / "k"), frame_start=2, frame_end=5,
                    downsample=0.5)
    write_mega_scene(str(root / "m"), n_train=3, n_val=1, img_wh=(24, 16))
    return dict(root_dir=str(root / "m"), downsample=0.5)


@pytest.mark.parametrize("name", ["synthetic", "nsvf", "kitti", "mega"])
def test_fit_takes_jax_sampler(name, tmp_path):
    if name == "synthetic":
        ref_ds = JData(split="train", img_size=16, n_train=3)
        got_ds = SyntheticDataset(split="train", img_size=16, n_train=3)
    else:
        kw = _fixture(name, tmp_path)
        ref_ds = jax_datasets[name](split="train", **kw)
        got_ds = dataset_dict[name](split="train", **kw)
    h = _tiny(dataset_name=name, batch_size=128)
    system = tt.NeRFSystem(h, got_ds, device="cpu")
    native = system.native_sampler()
    # JAX's fit takes its native sampler where the constructor accepts
    # the dataset (trainer.py:726-737); it does on all four
    if name == "kitti":
        assert got_ds.normals.shape[1] == 4 * got_ds.rays.shape[1]
    ref = JSampler(ref_ds, h.batch_size, seed=h.seed,
                   strategy=h.ray_sampling_strategy)
    try:
        assert native is not None
        _equal_batches(native.next_batch(), ref.next_batch())
    finally:
        ref.close()
        native.close()


def test_refused_layout_falls_back(capsys):
    ds = SyntheticDataset(split="train", img_size=8, n_train=2)
    system = tt.NeRFSystem(_tiny(), ds, device="cpu")
    assert system.native_sampler(False) is None
    ds.normals = ds.normals[:, :10]
    assert system.native_sampler() is None
    assert "native loader unavailable (normals" in capsys.readouterr().out
    with pytest.raises(ValueError, match="normals"):
        system.native_sampler(True)


def test_two_fit_steps_match_jax():
    """Both fits at their defaults: JAX's draws from its native sampler,
    the port's from its own, so the two train on the same rays. Both
    start from JAX's parameters with the hash tables scaled by 1e3, as
    the port's other step tests scale them, so that the encoders'
    features reach the loss: at their initial 1e-4 scale the second
    step's loss moves by ~1e-4 relative between the two packages (an
    Adam update of lr * g / (|g| + 1e-8) amplifies gradient differences
    on entries with |g| near 1e-8, tests/test_torch_train.py)."""
    h = _tiny()
    jtr = JData(split="train", img_size=24, n_train=4)
    jsys = jt.NeRFSystem(h, jtr, JData(split="test", img_size=24,
                                       n_test=1))
    params = jax.tree.map(lambda a: np.array(a, np.float32), jsys.params)
    for k in ("density_table", "rgb_table"):
        params["model"][k] *= 1e3
    jsys.params = jax.tree.map(jnp.asarray, params)
    jsys.opt_state = jsys.tx.init(jsys.params)
    ref = []
    jsys.fit(log_every=0, on_step=lambda s, aux: ref.append(
        float(aux["loss"])))
    tr = SyntheticDataset(split="train", img_size=24, n_train=4)
    psys = tt.NeRFSystem(h, tr, device="cpu", params=params)
    got = []
    psys.fit(log_every=0, on_step=lambda s, aux: got.append(
        float(aux["loss"])))
    assert len(got) == len(ref) == 2
    np.testing.assert_allclose(got, ref, rtol=1e-5)
    # the numpy stream trains on other rays
    psys = tt.NeRFSystem(h, tr, device="cpu", params=params)
    other = []
    psys.fit(log_every=0, use_native_loader=False,
             on_step=lambda s, aux: other.append(float(aux["loss"])))
    assert abs(other[0] - ref[0]) > 1e-5 * abs(ref[0])
