"""The port's Mega-NeRF loaders (ingp_tpu_torch/data/mega) against the
JAX package's (ingp_tpu/data/mega) on a scene the port writes
(utils/mega_fixture.py, 64x48 JPEG frames loaded at downsample 0.5, so
both resize with Lanczos): MegaDataset's rays (equal: both decode and
resize as PIL does), poses, K, directions and render_traj_rays as
test_torch_loaders.py's `_same` holds them; ImageMetadata's image and
keep mask; MemoryDataset's arrays; FilesystemDataset's chunks, chunk by
chunk as JAX reads its parquet through pyarrow (pixel indices, the
altitude clamp, full rays where the intrinsics differ), its resume and
reuse; ray_utils; and the reference's behaviour the port keeps (the
mega_frame_* flags never reach the loader, every item is_val, the split
is ignored). Then one training step of each package's NeRFSystem built
from hparams with dataset_name="mega", held to test_torch_train.py's
bounds as test_torch_data_train.py holds nsvf's."""
import os
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ingp_tpu.data.mega import dataset as jds
from ingp_tpu.data.mega import filesystem_dataset as jfs
from ingp_tpu.data.mega import memory_dataset as jmem
from ingp_tpu.data.mega import ray_utils as jru
from ingp_tpu.ops import pack as jp
from ingp_tpu.ops.march import build_block_table
from ingp_tpu.training import trainer as jt
from ingp_tpu_torch.data import dataset_dict
from ingp_tpu_torch.data.mega import dataset as tds
from ingp_tpu_torch.data.mega import filesystem_dataset as tfs
from ingp_tpu_torch.data.mega import memory_dataset as tmem
from ingp_tpu_torch.data.mega import ray_utils as tru
from ingp_tpu_torch.data.synthetic import sphere_density_grid
from ingp_tpu_torch.grid.occupancy import grid_from_density
from ingp_tpu_torch.training import trainer as tt
from ingp_tpu_torch.utils.mega_fixture import scene_poses, write_mega_scene
from tests.test_torch_loaders import _same
from tests.test_torch_train import N, T, _adam_moments, _leaf_close, hparams
from tests._torch_threads import one_torch_thread  # noqa: F401

WH = (64, 48)
ALTITUDE_RANGE = (-0.3, 0.35)   # planes above and below the cameras


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("aerial") / "scene"
    write_mega_scene(str(root), n_train=4, n_val=1, img_wh=WH, masks=True)
    return root


def _items(mod, root, scale_factor, masks=False):
    """Both train and val items of root through mod's metadata reader,
    with the fixture's keep masks when masks."""
    train, val = mod.get_image_metadata(root, scale_factor=scale_factor,
                                        train_every=1)
    items = train + val
    if masks:
        for it in items:
            split = "val" if it.image_path.parent.parent.name == "val" \
                else "train"
            it._mask_path = Path(root) / "masks" / split / \
                f"{Path(it.image_path).stem}.pt"
    return items


def test_mega_dataset_matches_jax(scene):
    ref, got = _same("mega", scene, "train", downsample=0.5)
    assert got.img_wh == (32, 24) and got.rays.shape == (4, 32 * 24, 3)
    # the fixture's cameras come back in the loader's frame
    np.testing.assert_allclose(got.poses, scene_poses(4), atol=1e-6)
    assert len(got.render_traj_rays) == 12
    # the test split is the train frames, as in JAX
    _, test = _same("mega", scene, "test", downsample=0.5)
    np.testing.assert_array_equal(test.rays, got.rays)


def test_metadata_items_image_and_mask_match_jax(scene):
    """is_val is True on every item of either package; the image and the
    keep mask of each item equal JAX's, resized (x0.5) and not."""
    for sf in (1, 2):
        ji = _items(jds, scene, sf, masks=True)
        ti = _items(tds, scene, sf, masks=True)
        assert [x.is_val for x in ti] == [x.is_val for x in ji] == [True] * 5
        assert [x.image_index for x in ti] == [x.image_index for x in ji]
        for a, b in zip(ji, ti):
            assert (b.W, b.H) == (a.W, a.H) == (WH[0] // sf, WH[1] // sf)
            np.testing.assert_array_equal(b.c2w, a.c2w)
            np.testing.assert_array_equal(b.intrinsics, a.intrinsics)
            img = b.load_image()
            assert img.dtype == np.float32
            np.testing.assert_array_equal(img, a.load_image())
            mask = b.load_mask()
            assert mask.dtype == bool and not mask.all() and mask.any()
            np.testing.assert_array_equal(mask, a.load_mask())
    partial_j = jds.get_image_metadata_partial(scene, 1, 2)[0]
    partial_t = tds.get_image_metadata_partial(scene, 1, 2)[0]
    assert [x.image_path.name for x in partial_t] == \
        [x.image_path.name for x in partial_j] == ["000001.jpg", "000002.jpg"]


def test_ray_utils_match_jax():
    dirs = tru.get_ray_directions(7, 5, 4.0, 4.5, 3.1, 2.2, True)
    np.testing.assert_array_equal(
        dirs, jru.get_ray_directions(7, 5, 4.0, 4.5, 3.1, 2.2, True))
    np.testing.assert_array_equal(
        tru.get_ray_directions(7, 5, 4.0, 4.5, 3.1, 2.2, False),
        jru.get_ray_directions(7, 5, 4.0, 4.5, 3.1, 2.2, False))
    # a camera looking along +x (down in Mega-NeRF's world) and tilted
    c2w = np.float32([[0, 0.2, -1, -1], [1, 0, 0, 0.3], [0, -1, -0.1, 0.2]])
    for rng in (None, (-2.0, 0.5), (-0.5, 3.0)):
        a = tru.get_rays(dirs, c2w, 0.1, 50.0, rng)
        b = jru.get_rays(dirs, c2w, 0.1, 50.0, rng)
        assert a.dtype == np.float32 and a.shape == (5, 7, 8)
        np.testing.assert_array_equal(a, b)
        assert np.all(a[..., 7] >= a[..., 6])
    clamped = tru.get_rays(dirs, c2w, 0.1, 50.0, (-2.0, 0.5))
    assert clamped[..., 7].max() < 50.0


@pytest.mark.parametrize("alt", [None, ALTITUDE_RANGE])
def test_memory_dataset_matches_jax(scene, alt):
    a = jmem.MemoryDataset(_items(jds, scene, 2, masks=True), 0.05, 3.0,
                           alt, True)
    b = tmem.MemoryDataset(_items(tds, scene, 2, masks=True), 0.05, 3.0,
                           alt, True)
    for k in ("_rgbs", "_rays", "_img_indices"):
        x, y = getattr(b, k), getattr(a, k)
        assert x.dtype == y.dtype and x.shape == y.shape, k
        np.testing.assert_array_equal(x, y, err_msg=k)
    assert len(b) < 5 * 32 * 24      # the masks dropped their corners
    rng = np.random.default_rng(0)
    s = b.sample_batch(rng, 16)
    assert s["rays"].shape == (16, 8) and s["rgbs"].shape == (16, 3)
    b.load_chunk()
    b.set_state(b.get_state())


def _chunks(ds):
    """[(name stem, rgbs, rays, img_indices)] of every chunk of a store,
    in its cyclic order from the first."""
    out = []
    for _ in range(len(ds._parquet_paths if hasattr(ds, "_parquet_paths")
                       else ds._chunk_paths)):
        ds.load_chunk()
        out.append((Path(ds.get_state()).name.split(".")[0],
                    ds._loaded_rgbs, ds._loaded_rays,
                    ds._loaded_img_indices))
    return out


@pytest.mark.parametrize("case", ["pixels", "pixels+altitude", "rays"])
def test_filesystem_dataset_chunks_match_jax(scene, tmp_path, case,
                                             monkeypatch):
    """Chunk k of the port's store holds exactly chunk k of JAX's: 5
    masked images in flushes of 1500 rays over 3 chunks (the last
    short), pixel indices with the same camera, full rays when one
    image's intrinsics differ; every kept ray stored once."""
    alt = ALTITUDE_RANGE if case == "pixels+altitude" else None
    items = {"jax": _items(jds, scene, 2, masks=True),
             "port": _items(tds, scene, 2, masks=True)}
    if case == "rays":
        for its in items.values():
            its[2].intrinsics = its[2].intrinsics * np.float32(1.1)
    stores = {}
    for name, mod in (("jax", jfs), ("port", tfs)):
        stores[name] = mod.FilesystemDataset(
            items[name], 0.05, 3.0, alt, True, [tmp_path / name / "a"], 3,
            2, disk_flush_size=1500)
    assert (stores["port"]._directions is None) == (case == "rays")
    got, ref = _chunks(stores["port"]), _chunks(stores["jax"])
    assert len(got) == len(ref) == 3
    for (gn, *g), (rn, *r) in zip(got, ref):
        assert gn == rn
        for x, y, what in zip(g, r, ("rgbs", "rays", "img_indices")):
            assert x.dtype == y.dtype and x.shape == y.shape, what
            np.testing.assert_array_equal(x, y, err_msg=f"{gn} {what}")
    mem = tmem.MemoryDataset(items["port"], 0.05, 3.0, alt, True)
    assert sum(len(c[1]) for c in got) == len(mem)
    cols = np.load(tmp_path / "port" / "a" / "000000.chunk" /
                   "img_indices.npy")
    assert cols.dtype == np.uint16

    # resume: a store built on the same directories reuses the chunks
    # (nothing rewritten) and set_state returns to a chunk by its name
    monkeypatch.setattr(tfs.FilesystemDataset, "_write_chunks", None)
    again = tfs.FilesystemDataset(items["port"], 0.05, 3.0, alt, True,
                                  [tmp_path / "port" / "a"], 3, 2)
    again.load_chunk()
    target = str(stores["port"]._chunk_paths[2])
    again.set_state(target)
    assert again.get_state() == target
    np.testing.assert_array_equal(again._loaded_rays, got[2][2])
    # JAX's parquet chunks are refused by name
    with pytest.raises(NotImplementedError, match="parquet chunks"):
        tfs.FilesystemDataset(items["port"], 0.05, 3.0, alt, True,
                              [tmp_path / "jax" / "a"], 3, 2)


def test_filesystem_dataset_two_directories_and_entry(scene, tmp_path,
                                                     monkeypatch):
    """load_filesystem_dataset: every 20th train image, near / far over
    the pose scale factor, chunks shared by two directories by their free
    disk (stated here, 3:1, so that both packages see the same shares);
    equal to JAX's chunk for chunk."""
    monkeypatch.setattr(shutil, "disk_usage", lambda p: (0, 0, 3 << 30)
                        if Path(p).name == "b" else (0, 0, 1 << 30))
    stores = [mod.load_filesystem_dataset(
        scene, near=1.0, far=100.0, chunk_paths=[tmp_path / n / "b",
                                                  tmp_path / n / "c"],
        num_chunks=4, scale_factor=2, disk_flush_size=10_000)
        for n, mod in (("port", tds), ("jax", jds))]
    got, ref = _chunks(stores[0]), _chunks(stores[1])
    assert len(got) == len(ref) == 4
    assert [p.parent.name for p in stores[0]._chunk_paths] == \
        ["b", "b", "b", "c"]
    for (gn, *g), (rn, *r) in zip(got, ref):
        assert gn == rn
        for x, y in zip(g, r):
            np.testing.assert_array_equal(x, y)
    assert stores[0]._near == 1.0 / 50.0 and stores[0]._far == 100.0 / 50.0
    assert sum(len(c[1]) for c in got) == 32 * 24


def test_mega_training_step_matches(scene):
    """One step of each package's NeRFSystem on the scene (hparams
    dataset_name="mega": the distortion weight 1e-4 and the real scenes'
    step factor 1/256). mega_frame_start/end are set to one frame; both
    trainers pass the loader only root_dir and downsample, so both train
    on the default window, all four frames."""
    h = hparams(dataset_name="mega", root_dir=str(scene), downsample=0.5,
                mega_frame_start=1, mega_frame_end=1)
    jsys = jt.NeRFSystem(h)
    assert tt.loss_config_from_hparams(h).lambda_distortion == 1e-4
    assert tt.render_config_from_hparams(h).exp_step_factor == 1 / 256
    params = jax.tree.map(lambda a: np.array(a, np.float32), jsys.params)
    params["model"]["density_table"] *= 1e4
    params["model"]["rgb_table"] *= 1e3
    psys = tt.NeRFSystem(h, device="cpu", params=params)
    assert type(psys.train_dataset).__name__ == "MegaDataset"
    assert psys.train_dataset.rays.shape[0] == \
        jsys.train_dataset.rays.shape[0] == 4
    np.testing.assert_array_equal(psys.train_dataset.rays,
                                  jsys.train_dataset.rays)
    np.testing.assert_array_equal(psys.test_dataset.poses,
                                  psys.train_dataset.poses)
    np.testing.assert_array_equal(N(psys.poses), np.asarray(jsys.poses))
    cfg = jsys.model_cfg
    dg = sphere_density_grid(cfg.grid_size, cfg.cascades, cfg.scale)
    bits = jp.packbits_u32(dg.reshape(-1), 0.5)
    psys.grid = grid_from_density(psys.grid, T(dg), 0.5, cfg.grid_size,
                                  cfg.cascades)
    rng = np.random.default_rng(1)
    b = psys.train_dataset.sample_batch(rng, h.batch_size)
    b["noise"] = rng.random(h.batch_size, dtype=np.float32)
    _, opt_j, _, aux_j = jsys.train_step(
        jax.tree.map(jnp.asarray, params), jsys.tx.init(
            jax.tree.map(jnp.asarray, params)), bits,
        build_block_table(bits, cfg.grid_size, cfg.cascades),
        jsys.directions, jsys.poses,
        {k: jnp.asarray(v) for k, v in b.items() if k in jsys.BATCH_KEYS},
        jnp.int32(0), jsys._base_key)
    aux, grads = psys.loss_and_grads(b, T(b["noise"]))
    assert float(aux["loss"]) > 0
    np.testing.assert_allclose(float(aux["loss"]), float(aux_j["loss"]),
                               rtol=1e-5)
    tt.clip_by_global_norm([g for _, g in tt.tree_leaves(grads)])
    g_j = jax.tree.map(lambda m: N(m) / np.float32(1 - 0.9),
                       _adam_moments(opt_j)[0])
    for name in grads["model"]:
        _leaf_close(grads["model"][name], g_j["model"][name],
                    3e-4 if name == "norm_net" else 1e-4, name)


def test_registry_builds_mega(scene):
    ds = dataset_dict["mega"](root_dir=str(scene), split="train",
                              downsample=0.25)
    assert isinstance(ds, tds.MegaDataset) and ds.img_wh == (16, 12)
    assert os.path.exists(os.path.join(scene, "coordinates.pt"))
