"""The port's visualisation helpers and validation dumps
(ingp_tpu_torch/utils/vis.py, NeRFSystem._dump_val_images,
JsonlLogger.log_image) against the JAX package's: the TURBO and BONE
tables equal cv2.applyColorMap entry for entry (BGR order included), the
colour-mapped images equal JAX's, and the dumps' PNG files decode to
JAX's pixel for pixel from the same render outputs."""
import os
from types import SimpleNamespace

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from ingp_tpu.training.trainer import NeRFSystem as JaxSystem
from ingp_tpu.utils import loggers as jax_loggers
from ingp_tpu.utils import vis as jax_vis
from ingp_tpu_torch.data.image_io import read_png
from ingp_tpu_torch.training.trainer import NeRFSystem
from ingp_tpu_torch.utils import loggers, vis
from tests._torch_threads import one_torch_thread  # noqa: F401

RNG = np.random.default_rng(0)


@pytest.mark.parametrize("table,cmap", [(vis.TURBO, cv2.COLORMAP_TURBO),
                                        (vis.BONE, cv2.COLORMAP_BONE)])
def test_colormaps_equal_opencv(table, cmap):
    ramp = np.arange(256, dtype=np.uint8).reshape(16, 16)
    assert table.shape == (256, 3) and table.dtype == np.uint8
    np.testing.assert_array_equal(vis.colormap(ramp, table),
                                  cv2.applyColorMap(ramp, cmap))


def test_colour_mapped_images_equal_jax():
    depth = RNG.random((9, 11), dtype=np.float32) * 1.3
    np.testing.assert_array_equal(vis.depth2img(depth, scale=1.0),
                                  jax_vis.depth2img(depth, scale=1.0))
    mask = RNG.random((9, 11), dtype=np.float32)
    np.testing.assert_array_equal(vis.mask2img(mask), jax_vis.mask2img(mask))
    labels = RNG.integers(0, 7, (9, 11))
    np.testing.assert_array_equal(vis.semantic2img(labels, 7),
                                  jax_vis.semantic2img(labels, 7))
    normal = RNG.normal(size=(9, 11, 3))
    pose = RNG.normal(size=(3, 4))
    np.testing.assert_array_equal(vis.convert_normal(normal, pose),
                                  jax_vis.convert_normal(normal, pose))


@pytest.mark.parametrize("shape", [(7, 5), (7, 5, 3), (7, 5, 4)])
def test_save_image_matches_jax(tmp_path, shape):
    img = RNG.random(shape) * 1.2 - 0.1
    vis.save_image(img, tmp_path / "port.png")
    jax_vis.save_image(img, tmp_path / "jax.png")
    np.testing.assert_array_equal(read_png(tmp_path / "port.png"),
                                  np.asarray(Image.open(tmp_path / "jax.png")))


def test_logger_log_image_matches_jax(tmp_path):
    img = RNG.random((6, 8, 3))
    for mod, sub in ((loggers, "port"), (jax_loggers, "jax")):
        log = mod.JsonlLogger(str(tmp_path / sub / "metrics.jsonl"))
        log.log_image(12, "rgb", img)
        log.close()
    assert os.listdir(tmp_path / "port" / "val") == ["00012_rgb.png"]
    np.testing.assert_array_equal(
        read_png(tmp_path / "port" / "val" / "00012_rgb.png"),
        read_png(tmp_path / "jax" / "val" / "00012_rgb.png"))


@pytest.mark.parametrize("semantic", [False, True])
def test_dump_val_images_match_jax(tmp_path, semantic):
    w, h = 12, 10
    n = w * h
    res = {"rgb": RNG.random((n, 3), dtype=np.float32) * 1.1,
           "depth": RNG.random(n, dtype=np.float32),
           "normal_pred": RNG.normal(size=(n, 3)).astype(np.float32),
           "normal_raw": RNG.normal(size=(n, 3)).astype(np.float32),
           "semantic": RNG.integers(0, 5, n)}
    pose = RNG.normal(size=(3, 4)).astype(np.float32)
    test = SimpleNamespace(img_wh=(w, h),
                           test_item=lambda i: {"pose": pose, "img_idxs": i})
    hp = SimpleNamespace(scale=0.5, render_semantic=semantic, num_classes=5)
    tag = "semantic" if semantic else "plain"
    jax_fake = SimpleNamespace(test_dataset=test, hparams=hp,
                               render_image=lambda p: res)
    JaxSystem._dump_val_images(jax_fake, str(tmp_path / "jax" / tag), 7)
    port_fake = SimpleNamespace(
        test_dataset=test, hparams=hp,
        render_image=lambda p: {**{k: torch.from_numpy(np.asarray(v))
                                   for k, v in res.items()},
                                "total_samples": 3})
    NeRFSystem._dump_val_images(port_fake, str(tmp_path / "port" / tag), 7)
    names = sorted(os.listdir(tmp_path / "jax" / tag / "val"))
    assert sorted(os.listdir(tmp_path / "port" / tag / "val")) == names
    assert len(names) == (5 if semantic else 4)
    for name in names:
        np.testing.assert_array_equal(
            read_png(tmp_path / "port" / tag / "val" / name),
            np.asarray(Image.open(tmp_path / "jax" / tag / "val" / name)),
            err_msg=name)
