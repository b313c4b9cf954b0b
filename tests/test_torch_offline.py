"""Port parity of the offline render layer (render/offline.py,
aux_heads.py, panorama.py, the CLIs) against ingp_tpu on CPU.

Both sides render one scene from the same parameters: a TNT fixture of
the sphere scene (32x18 views, a camera path, semantics), the hash
encoder at tiny widths with appearance codes, the port system's initial
parameters (JAX's draws, core/prng.py) with their tables scaled up so
that the encoders' features matter and the density raised, as numpy in JAX's layouts on both
sides (the port's through `params_from_numpy`), and the grid of the
scene's spheres on both. Held: `render_chunks` (chunks of 100 rays with a padded
tail) to the bounds of test_torch_train_render.py; every PNG that
`render_for_test` writes (test poses with the "mean" appearance code,
the camera path, an anti-aliased render whose test split was built with
the factor) decoded at most 1 level apart on at most 0.1% of values,
under the same file names; the aux passes' PGMs the same way; the
panorama's directions and samples within 1e-6. The CLIs run on the CPU
(`main(argv, device="cpu")`), `train.main` through its end-of-run
render, and the video route through a stand-in `ffmpeg` on PATH."""
import os
import stat
import sys
from types import SimpleNamespace

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ingp_tpu.data.tnt import TNTDataset as JTNT
from ingp_tpu.render import aux_heads as jaux
from ingp_tpu.render import offline as joff
from ingp_tpu.render import panorama as jpano
from ingp_tpu.training import trainer as jt

from ingp_tpu_torch import render_cli, render_panorama_cli
from ingp_tpu_torch import train as train_cli
from ingp_tpu_torch.data.image_io import read_pgm, read_png
from ingp_tpu_torch.data.synthetic import sphere_density_grid
from ingp_tpu_torch.data.tnt import TNTDataset
from ingp_tpu_torch.grid.occupancy import grid_from_density
from ingp_tpu_torch.render import aux_heads as taux
from ingp_tpu_torch.render import offline as toff
from ingp_tpu_torch.render import panorama as tpano
from ingp_tpu_torch.training import trainer as tt
from ingp_tpu_torch.utils.blender_fixture import write_tnt_scene

from tests.test_torch_train import N, T, hparams
from tests._torch_threads import one_torch_thread  # noqa: F401

# tests/test_cli.py's TINY sizes for the port's entry points, without
# --no_save_test
TINY = ["--dataset_name", "synthetic", "--num_epochs", "1",
        "--normal_epochs", "0", "--steps_per_epoch", "8",
        "--batch_size", "256", "--capacity", "32", "--march_iters", "128",
        "--samples_per_ray", "8", "--grid_size", "32",
        "--density_L", "4", "--density_F", "2", "--density_log2T", "12",
        "--rgb_L", "4", "--rgb_F", "2", "--rgb_log2T", "12",
        "--chunk_size", "1024"]
CHUNK = 100


def _hparams(**kw):
    base = dict(dataset_name="tnt", encoder="hash", embed_a=True,
                embed_a_len=4, chunk_size=CHUNK, capacity=32,
                march_iters=512, samples_per_ray=8, render_rgb=True,
                render_depth=True, render_normal=True, render_semantic=True,
                render_traj=False, anti_aliasing_factor=1.0,
                no_save_test=False, exp_name="offline", density_L=2, rgb_L=2)
    base.update(kw)
    return hparams("f32", **base)


class Scene:
    """A port system on a TNT fixture with its tables scaled up and the
    grid of the scene's spheres, and the JAX package's view of the same
    system: what its render functions read (configs from JAX's own
    mappings, the port's parameters in JAX's layouts, the bitfield and
    block table, JAX's loaders on the same files)."""

    def __init__(self, root):
        self.root = str(root)
        h = _hparams()
        self.tr = TNTDataset(self.root, split="train")
        self.psys = tt.NeRFSystem(h, self.tr,
                                  TNTDataset(self.root, split="test"),
                                  device="cpu")
        params = self.psys.params_to_numpy()
        params["model"]["density_table"] *= 1e4
        params["model"]["rgb_table"] *= 1e3
        # a denser field, so that the 32 samples a ray reach opacity
        params["model"]["xyz_net"][-1]["b"][0] += 8.0
        self.params = params
        self.psys.load_state({"params": params})
        cfg = self.psys.model_cfg
        dg = sphere_density_grid(cfg.grid_size, cfg.cascades, cfg.scale)
        self.psys.grid = grid_from_density(self.psys.grid, T(dg), 0.5,
                                           cfg.grid_size, cfg.cascades)
        self.bits = self.psys.grid["bitfield"].numpy().view(np.uint32)
        self.table = self.psys.grid["block_table"].numpy().view(np.uint32)
        self.jtr = JTNT(self.root, split="train")
        self.jsys = self.jax_system(JTNT(self.root, split="test"))

    def jax_system(self, test_ds):
        h = _hparams()
        return SimpleNamespace(
            model_cfg=jt.model_config_from_hparams(h),
            render_cfg_test=jt.render_config_from_hparams(h, test=True),
            params=jax.tree.map(jnp.asarray, self.params),
            grid={"bitfield": jnp.asarray(self.bits)},
            _march_table=lambda: jnp.asarray(self.table),
            train_dataset=self.jtr, test_dataset=test_ds)

    def port_system(self, test_ds):
        """The port system with another test split (shares its state)."""
        s = SimpleNamespace(**vars(self.psys))
        s.test_dataset = test_ds
        return s


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("scene") / "tnt"
    write_tnt_scene(str(root), img_wh=(32, 18), n_train=4, n_test=2,
                    n_path=2)
    return Scene(root)


def _close_u8(a, b, what):
    """Two decoded 8-bit images at most 1 level apart on at most 0.1% of
    their values (a float output ~1e-5 from a rounding edge can land on
    the other side of it)."""
    assert a.shape == b.shape, (what, a.shape, b.shape)
    d = np.abs(a.astype(np.int32) - b.astype(np.int32))
    assert d.max() <= 1 and (d > 0).mean() <= 1e-3, (what, d.max(),
                                                      (d > 0).mean())


def _render_both(scene, monkeypatch, tmp_path, jsys, psys, h):
    """render_for_test of each system, each in its own working
    directory: (JAX's output dir, the port's, the port's printed lines)."""
    outs = []
    for side, sys_ in (("jax", jsys), ("port", psys)):
        monkeypatch.chdir(tmp_path / side if (tmp_path / side).is_dir()
                          else _mkdir(tmp_path / side))
        mod = joff if side == "jax" else toff
        outs.append(os.path.abspath(mod.render_for_test(h, system=sys_)))
    return outs


def _mkdir(p):
    p.mkdir()
    return p


def _same_pngs(jdir, tdir, expect):
    names = sorted(os.listdir(tdir))
    assert names == sorted(os.listdir(jdir)) == sorted(expect)
    for name in names:
        _close_u8(read_png(os.path.join(tdir, name)),
                  read_png(os.path.join(jdir, name)), name)


def test_render_chunks_matches(scene):
    jsys, psys = scene.jsys, scene.psys
    ds = psys.test_dataset
    ro, rd = (N(a) for a in jt.get_rays(jnp.asarray(ds.directions),
                                         jnp.asarray(ds.poses[1])))
    emb = N(scene.params["embedding_a"][1:2])
    assert len(ro) % CHUNK
    ref = joff.render_chunks(jsys.model_cfg, jsys.render_cfg_test,
                             jsys.params["model"], jsys.grid["bitfield"],
                             ro, rd, CHUNK, embedding_a=emb,
                             block_table=scene.table)
    out = toff.render_chunks(psys.model_cfg, psys.render_cfg_test,
                             psys.params["model"], psys.grid["bitfield"],
                             T(ro), T(rd), CHUNK, embedding_a=T(emb),
                             block_table=psys.grid["block_table"])
    assert set(out) == set(ref)
    assert out["total_samples"] == ref["total_samples"] > 0
    assert (ref["opacity"] > 0.05).any()
    np.testing.assert_array_equal(N(out["semantic"]), ref["semantic"])
    for k in ("rgb", "depth", "opacity", "normal_pred", "normal_raw",
              "semantic_probs", "points"):
        frac = 1e-3 if k == "normal_raw" else 1e-4
        np.testing.assert_allclose(N(out[k]), ref[k], rtol=1e-4,
                                   atol=frac * np.abs(ref[k]).max(),
                                   err_msg=k)


def test_render_chunks_at_render_image_chunk_is_render_image(scene):
    """At render_image's chunk (its 1.5 M-sample cap) the two renders are
    one computation: every output equal. At another chunk the sample
    budget (rays x samples_per_ray a chunk) can overflow on other rays,
    so they may differ where it does (PERF.md §7)."""
    p = scene.psys
    pose = p.test_dataset.poses[0]
    ref = p.render_image(pose)
    ro, rd = tt.get_rays(T(p.test_dataset.directions), T(pose))
    out = toff.render_chunks(p.model_cfg, p.render_cfg_test,
                             p.params["model"], p.grid["bitfield"], ro, rd,
                             p.hparams.chunk_size,
                             embedding_a=p.params["embedding_a"][0:1],
                             block_table=p.grid["block_table"])
    assert out["total_samples"] == ref["total_samples"] > 0
    for k in ref:
        if k != "total_samples":
            assert torch.equal(out[k], ref[k]), k


@pytest.mark.parametrize("traj", [False, True])
def test_render_for_test_writes_jax_frames(scene, monkeypatch, tmp_path,
                                           capsys, traj):
    h = _hparams(render_traj=traj)
    jdir, tdir = _render_both(scene, monkeypatch, tmp_path, scene.jsys,
                              scene.psys, h)
    n = 2
    _same_pngs(jdir, tdir, [f"{i:05d}_{k}.png" for i in range(n)
                            for k in ("rgb", "depth", "normal", "semantic")])
    # no ffmpeg here: each side says that it skips each video
    lines = capsys.readouterr().out.splitlines()
    for name in ("rgb", "depth", "normal", "semantic"):
        assert sum(f"video write skipped ({name})" in x for x in lines) == 2
    assert any("no ffmpeg executable on PATH" in x for x in lines)


def test_render_for_test_anti_aliased(scene, monkeypatch, tmp_path):
    h = _hparams(anti_aliasing_factor=2.0, render_traj=True,
                 no_save_test=True)
    jte = JTNT(scene.root, split="test", anti_aliasing_factor=2.0)
    te = TNTDataset(scene.root, split="test", anti_aliasing_factor=2.0)
    assert len(te.directions) == 4 * 32 * 18
    jdir, tdir = _render_both(scene, monkeypatch, tmp_path,
                              scene.jax_system(jte), scene.port_system(te), h)
    _same_pngs(jdir, tdir, [f"{i:05d}_{k}.png" for i in range(2)
                            for k in ("rgb", "depth", "normal", "semantic")])
    # the test split at the plain size: the port refuses before it
    # renders, JAX fails at its reshape
    monkeypatch.chdir(tmp_path)
    with pytest.raises(ValueError, match="anti_aliasing_factor 2.0"):
        toff.render_for_test(_hparams(anti_aliasing_factor=2.0,
                                      exp_name="aa_plain"),
                             system=scene.psys)
    assert not (tmp_path / "results" / "tnt" / "aa_plain").exists()
    with pytest.raises(ValueError):
        joff.render_for_test(h, system=scene.jsys)


def test_aux_heads_match(scene, tmp_path):
    j, p = scene.jsys, scene.psys
    emb = scene.params["embedding_a"][:1]
    args = dict(chunk_size=CHUNK)
    jd = jaux.render_semantic_labels(
        j.model_cfg, j.render_cfg_test, j.params["model"],
        j.grid["bitfield"], j.test_dataset, str(tmp_path / "j"),
        embedding_a=emb, **args)
    td = taux.render_semantic_labels(
        p.model_cfg, p.render_cfg_test, p.params["model"],
        p.grid["bitfield"], p.test_dataset, str(tmp_path / "t"),
        embedding_a=T(emb), **args)
    up = [0.0, 0.0, 1.0]    # near this untrained field's normals
    jm = jaux.render_up_normal_masks(
        j.model_cfg, j.render_cfg_test, j.params["model"],
        j.grid["bitfield"], j.test_dataset, up, str(tmp_path / "j"),
        embedding_a=emb, **args)
    tm = taux.render_up_normal_masks(
        p.model_cfg, p.render_cfg_test, p.params["model"],
        p.grid["bitfield"], p.test_dataset, up, str(tmp_path / "t"),
        embedding_a=T(emb), **args)
    for a, b, names in ((jd, td, ["00000.pgm", "00001.pgm"]),
                        (jm, tm, ["msk_00000.pgm", "msk_00001.pgm"])):
        assert sorted(os.listdir(b)) == sorted(os.listdir(a)) == names
        for name in names:
            x, y = read_pgm(os.path.join(b, name)), \
                read_pgm(os.path.join(a, name))
            assert x.shape == (18, 32)
            _close_u8(x, y, name)
    assert any(read_pgm(os.path.join(tm, n)).any()
               for n in ("msk_00000.pgm", "msk_00001.pgm"))


def test_panorama_matches(scene, tmp_path):
    fwd, down, right = (0.0, 0.0, 1.0), (0.0, 1.0, 0.0), (1.0, 0.0, 0.0)
    for H, W in ((8, 16), (9, 20)):
        ref = jpano.panorama_directions(H, W, *(np.asarray(v, np.float32)
                                                for v in (fwd, down, right)))
        out = tpano.panorama_directions(H, W, fwd, down, right)
        np.testing.assert_allclose(N(out), ref, rtol=0, atol=1e-6)
    rng = np.random.default_rng(0)
    pano = rng.random((9, 20, 3)).astype(np.float32)
    dirs = rng.normal(size=(300, 3))
    dirs[:4] = [[0, 1, 0], [0, -1, 0], [-1, 0, 0], [0, 0, -1]]
    basis = [np.asarray(v) for v in (fwd, down, right)]
    ref = jpano.sample_panorama(dirs, pano, *basis)
    out = tpano.sample_panorama(dirs, pano, *basis)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(N(out), ref, rtol=0, atol=1e-6)

    j, p = scene.jsys, scene.psys
    emb = scene.params["embedding_a"][:1]
    kw = dict(pano_hw=(8, 16), origin=(0.0, 0.0, -0.8), chunk_size=CHUNK)
    jr = jpano.render_panorama(j.model_cfg, j.render_cfg_test,
                               j.params["model"], j.grid["bitfield"],
                               str(tmp_path / "j"), embedding_a=emb, **kw)
    tr = tpano.render_panorama(p.model_cfg, p.render_cfg_test,
                               p.params["model"], p.grid["bitfield"],
                               str(tmp_path / "t"), embedding_a=T(emb), **kw)
    assert jr["opacity"].max() > 0.05
    for k in ("rgb", "opacity"):
        np.testing.assert_allclose(tr[k], jr[k], rtol=1e-4,
                                   atol=1e-4 * np.abs(jr[k]).max())
    np.testing.assert_array_equal(tr["mask"], jr["mask"])
    for sub in ("rgb", "opacity", "mask"):
        rel = os.path.join("panorama", sub, "0.png")
        _close_u8(read_png(tmp_path / "t" / rel),
                  read_png(tmp_path / "j" / rel), sub)


def test_write_videos_through_ffmpeg(tmp_path, monkeypatch, capsys):
    """A stand-in ffmpeg on PATH records its arguments and the bytes fed
    to it: the frames, raw rgb24, in order, with imageio's settings."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    exe = bin_dir / "ffmpeg"
    exe.write_text(
        f"#!{sys.executable}\n"
        "import sys\n"
        "open(sys.argv[-1] + '.args', 'w').write('\\n'.join(sys.argv[1:]))\n"
        "open(sys.argv[-1], 'wb').write(sys.stdin.buffer.read())\n")
    exe.chmod(exe.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setenv("PATH", str(bin_dir))
    rng = np.random.default_rng(1)
    frames = {"rgb": [rng.integers(0, 256, (18, 32, 3), dtype=np.uint8)
                      for _ in range(3)],
              "depth": [np.zeros((18, 32, 3), np.uint8)], "normal": []}
    toff._write_videos(str(tmp_path), frames)
    data = (tmp_path / "rgb.mp4").read_bytes()
    assert data == b"".join(f.tobytes() for f in frames["rgb"])
    args = (tmp_path / "rgb.mp4.args").read_text().split("\n")
    assert args[:14] == ["-y", "-f", "rawvideo", "-vcodec", "rawvideo",
                         "-s", "32x18", "-pix_fmt", "rgb24", "-r", "30.00",
                         "-i", "-", "-an"]
    assert args[14:] == ["-vcodec", "libx264", "-pix_fmt", "yuv420p",
                         "-crf", "25", "-v", "warning", "-vf",
                         "scale=32:32", str(tmp_path / "rgb.mp4")]
    assert not (tmp_path / "depth.mp4").exists()
    assert capsys.readouterr().out == ""
    exe.write_text(f"#!{sys.executable}\nimport sys\nsys.stdin.buffer.read()\n"
                   "sys.exit('bad')\n")
    toff._write_videos(str(tmp_path), frames)
    assert "video write skipped (rgb): ffmpeg exited with 1: bad" in \
        capsys.readouterr().out


def test_cli_entry_points_on_cpu(tmp_path, monkeypatch, capsys):
    """train.main runs to its end-of-run render; then render_cli and
    render_panorama_cli on its checkpoint."""
    monkeypatch.chdir(tmp_path)
    argv = TINY + ["--exp_name", "cli", "--render_rgb", "--render_depth",
                   "--steps_per_epoch", "2", "--downsample", "0.25"]
    m = train_cli.main(argv, device="cpu")
    assert np.isfinite(m["psnr"])
    run = tmp_path / "results" / "synthetic" / "cli"
    names = sorted(os.listdir(run))
    n = len(tt._datasets_from_hparams(SimpleNamespace(
        dataset_name="synthetic", root_dir="", downsample=0.25,
        split="train"))[1].poses)
    assert names == sorted(f"{i:05d}_{k}.png" for i in range(n)
                           for k in ("rgb", "depth"))
    first = read_png(run / "00000_rgb.png")
    assert "video write skipped (rgb)" in capsys.readouterr().out
    for name in names:
        os.remove(run / name)
    assert render_cli.main(argv, device="cpu") == os.path.join(
        "results", "synthetic", "cli")
    assert sorted(os.listdir(run)) == names
    # the render from the checkpoint is the end-of-run render
    np.testing.assert_array_equal(read_png(run / "00000_rgb.png"), first)
    res = render_panorama_cli.main(
        argv + ["--pano_h", "8", "--pano_w", "16", "--ckpt_load",
                "ckpts/synthetic/cli/last"], device="cpu")
    for sub, shape in (("rgb", (8, 16, 3)), ("opacity", (8, 16)),
                       ("mask", (8, 16))):
        assert read_png(run / "panorama" / sub / "0.png").shape == shape
    assert 0.0 <= res["opacity"].mean() <= 1.0
    with pytest.raises(ValueError, match="anti_aliasing_factor"):
        render_cli.main(argv + ["--anti_aliasing_factor", "2"],
                        device="cpu")
