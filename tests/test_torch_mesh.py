"""Port parity of mesh extraction (render/mesh.py) against
ingp_tpu/render/mesh.py on CPU: the isosurface of the same volumes
(vertices within 1e-9, faces equal, `write_ply` bytes equal), the
density probe through each side's `ngp_sigma` in JAX's chunks with its
padded tail (rtol 1e-5), and the port's `extract_mesh_cli` and
`render_panorama_cli`, reached as the command line reaches them (a
--config file, flags after it, `main()` reading sys.argv), against the
JAX CLIs on the same checkpoint: the panorama's PNGs; the mesh's PLY
header and surface (its bytes differ: the two probes' volumes differ by
~1e-6, so a few corners at the threshold and the rounding weld fall
otherwise, see `test_extract_mesh_cli_writes_jax_mesh`)."""
import sys
from functools import partial

import numpy as np
import jax
import pytest
import torch

from ingp_tpu import extract_mesh_cli as jmesh_cli
from ingp_tpu import render_panorama_cli as jpano_cli
from ingp_tpu.models import ngp as jngp
from ingp_tpu.render import mesh as jmesh
from ingp_tpu.utils import ckpt as jckpt

from ingp_tpu_torch import extract_mesh_cli, render_panorama_cli
from ingp_tpu_torch.core import prng
from ingp_tpu_torch.data.image_io import read_png
from ingp_tpu_torch.models import ngp as tngp
from ingp_tpu_torch.ops.march import build_block_table
from ingp_tpu_torch.render import mesh as tmesh
from ingp_tpu_torch.training.config import get_opts
from ingp_tpu_torch.utils import ckpt as tckpt
from tests._torch_threads import one_torch_thread  # noqa: F401


def _volume(seed, shape):
    """A smooth random field: a sum of Gaussian blobs."""
    rng = np.random.default_rng(seed)
    grid = np.stack(np.meshgrid(*[np.arange(n) for n in shape],
                                indexing="ij"), -1).astype(np.float64)
    vol = np.zeros(shape)
    for _ in range(4):
        c = rng.uniform(0, 1, 3) * np.array(shape)
        r = rng.uniform(1.5, 4.0)
        vol += rng.uniform(5, 20) * np.exp(
            -((grid - c) ** 2).sum(-1) / (2 * r * r))
    return vol.astype(np.float32)


@pytest.mark.parametrize("seed,shape,level", [
    (0, (12, 10, 14), 10.0), (1, (9, 16, 11), 4.0), (2, (6, 6, 6), 1e3)])
def test_isosurface_and_ply_equal(tmp_path, seed, shape, level):
    vol = _volume(seed, shape)
    # exact crossings at corner values: t at the clip bounds and ties
    vol[2, 3, 4] = level
    jv, jf = jmesh.marching_cubes(vol, level)
    tv, tf = tmesh.marching_cubes(torch.as_tensor(vol), level)
    tv, tf = tv.numpy(), tf.numpy()
    assert tv.dtype == np.float64 and tv.shape == jv.shape
    if level < 1e3:
        assert len(jf) > 50
    np.testing.assert_allclose(tv, jv, rtol=0, atol=1e-9)
    np.testing.assert_array_equal(tf, jf)
    jmesh.write_ply(tmp_path / "j.ply", jv, jf)
    tmesh.write_ply(tmp_path / "t.ply", tv, tf)
    assert (tmp_path / "t.ply").read_bytes() == \
        (tmp_path / "j.ply").read_bytes()


@pytest.mark.parametrize("encoder", ["hash", "brick"])
def test_density_probe_matches(encoder):
    kw = dict(encoder=encoder, density_L=4, rgb_L=2, density_log2T=12,
              rgb_log2T=12, grid_size=32)
    jc, tc = jngp.NGPConfig(**kw), tngp.NGPConfig(**kw)
    # the port's init draws JAX's values (tests/test_torch_prng.py)
    params = tngp.params_to_numpy(tngp.ngp_init(tc, prng.prng_key(0),
                                                device="cpu"), cfg=tc)
    params["density_table"] = params["density_table"] * 1e3
    res, chunk = (12, 10, 14), 1000       # two chunks, the second padded
    seen = []
    sigma = jax.jit(partial(jngp.ngp_sigma, jc))

    def jfn(p, x):
        out = sigma(p, x)
        seen.append(np.asarray(out))
        return out
    level = 1.0
    jv, jf = jmesh.extract_mesh(jfn, params, 0.5, res, level, chunk)
    ref = np.concatenate([seen[0], seen[1][:res[0] * res[1] * res[2]
                                           - chunk]]).reshape(res)
    tp = tngp.params_from_numpy(params, cfg=tc)
    vol, _ = tmesh.probe_density(lambda p, x: tngp.ngp_sigma(tc, p, x), tp,
                                 0.5, res, chunk, torch.device("cpu"))
    assert [len(s) for s in seen] == [chunk, chunk]
    np.testing.assert_allclose(vol.numpy(), ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())
    # the isosurface of JAX's volume, placed in the world, is JAX's mesh
    tv, tf = tmesh.marching_cubes(torch.as_tensor(ref), level)
    axes = [np.linspace(-0.5, 0.5, r) for r in res]
    tv = tv.numpy() * np.array([a[1] - a[0] for a in axes]) \
        + np.array([a[0] for a in axes])
    np.testing.assert_allclose(tv, jv, rtol=0, atol=1e-9)
    np.testing.assert_array_equal(tf.numpy(), jf)


RES = ["--mesh_resolution", "16", "12", "20"]


class Checkpoint:
    """The port system of the TINY flags, its density tables scaled up
    so that the field has structure and its grid all occupied, saved as
    a port checkpoint and as the same state in the JAX package's; a
    --config file of the flags (with an exp_name that the command line
    overrides) and the level at the field's median density."""

    def __init__(self, root):
        from tests.test_torch_offline import TINY
        from ingp_tpu_torch.training.trainer import NeRFSystem
        self.root = root
        pairs = [(TINY[i][2:], TINY[i + 1]) for i in range(0, len(TINY), 2)]
        self.config = root / "tiny.txt"
        self.config.write_text("".join(f"{k} = {v}\n" for k, v in pairs)
                               + "exp_name = config\n")
        h = get_opts(["--config", str(self.config)],
                     extract_mesh_cli.add_args)
        system = NeRFSystem(h, device="cpu")
        state = system.state()
        state["params"]["model"]["density_table"] *= 3e4
        grid = state["grid"]
        grid["bitfield"][:] = -1
        cfg = system.model_cfg
        grid["block_table"] = build_block_table(
            torch.as_tensor(grid["bitfield"]), cfg.grid_size,
            cfg.cascades).numpy()
        tckpt.save_ckpt(str(root / "port_ckpt"), state)
        jstate = dict(state, grid=dict(grid, **{
            k: grid[k].view(np.uint32) for k in ("bitfield",
                                                 "block_table")}))
        del jstate["opt_state"]
        jckpt.save_ckpt(str(root / "jax_ckpt"), jstate)
        system.load_state(state)
        vol, _ = tmesh.probe_density(
            lambda p, x: tngp.ngp_sigma(cfg, p, x), system.params["model"],
            0.5, (16, 12, 20), 2 ** 17, torch.device("cpu"))
        self.level = str(float(vol.median()))

    def run(self, side, main, flags, monkeypatch):
        """main on this checkpoint in the side's own working directory:
        the port's as `python -m ... --config ...` calls it, with
        sys.argv, JAX's with the same list. Returns its results
        directory."""
        cwd = self.root / side
        cwd.mkdir(exist_ok=True)
        monkeypatch.chdir(cwd)
        argv = ["--config", str(self.config), "--exp_name", "cli",
                "--ckpt_load", str(self.root / f"{side}_ckpt")] + flags
        if side == "port":
            monkeypatch.setattr(sys, "argv", ["cli"] + argv)
            main(device="cpu")
        else:
            main(argv)
        return cwd / "results" / "synthetic" / "cli"


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    return Checkpoint(tmp_path_factory.mktemp("cli"))


def _read_ply(path):
    """(header lines, (V, 3) float32 vertices, (F, 3) int32 faces) of a
    binary PLY as write_ply writes it."""
    head, body = path.read_bytes().split(b"end_header\n", 1)
    lines = head.decode().splitlines()
    n = {ln.split()[1]: int(ln.split()[2]) for ln in lines
         if ln.startswith("element ")}
    assert len(body) == 12 * n["vertex"] + 13 * n["face"]
    verts = np.frombuffer(body[:12 * n["vertex"]], "<f4").reshape(-1, 3)
    rec = np.frombuffer(body[12 * n["vertex"]:],
                        [("n", "u1"), ("idx", "<i4", 3)])
    assert (rec["n"] == 3).all()
    return lines, verts, rec["idx"]


def test_extract_mesh_cli_writes_ply(checkpoint, monkeypatch):
    """The port's CLI as the command line reaches it: the flags after
    --config reach it (the checkpoint, the resolution, the threshold,
    the exp_name over the config's), and it writes the isosurface of the loaded
    field, placed in the scene box."""
    out = checkpoint.run("port", extract_mesh_cli.main,
                         RES + ["--sigma_threshold", checkpoint.level],
                         monkeypatch)
    lines, verts, faces = _read_ply(out / "mesh.ply")
    assert len(faces) > 1000 and faces.max() == len(verts) - 1
    assert np.abs(verts).max() <= 0.5 + 1e-6


def test_extract_mesh_cli_writes_jax_mesh(checkpoint, monkeypatch):
    """The JAX CLI on the same checkpoint and flags writes the same
    surface: the PLY headers alike but for the two counts, which agree
    within 0.5%; every vertex within 1e-5 of the other mesh's nearest;
    at most 0.5% of JAX's triangles without a port triangle within 1e-5
    (measured: 0.1%, the corners within the probes' ~1e-6 difference
    of the threshold; the isosurface and the PLY bytes are equal on one
    volume, test_isosurface_and_ply_equal)."""
    from scipy.spatial import cKDTree
    flags = RES + ["--sigma_threshold", checkpoint.level]
    port = checkpoint.run("port", extract_mesh_cli.main, flags, monkeypatch)
    ref = checkpoint.run("jax", jmesh_cli.main, flags, monkeypatch)
    (tl, tv, tf), (jl, jv, jf) = (_read_ply(d / "mesh.ply")
                                  for d in (port, ref))
    assert [ln for ln in tl if not ln.startswith("element")] == \
        [ln for ln in jl if not ln.startswith("element")]
    assert [ln.split()[:2] for ln in tl if ln.startswith("element")] == \
        [["element", "vertex"], ["element", "face"]]
    assert len(jf) > 1000
    assert abs(len(tv) - len(jv)) <= 5e-3 * len(jv)
    assert abs(len(tf) - len(jf)) <= 5e-3 * len(jf)
    assert cKDTree(jv).query(tv)[0].max() <= 1e-5
    assert cKDTree(tv).query(jv)[0].max() <= 1e-5
    far = cKDTree(tv[tf].reshape(-1, 9)).query(jv[jf].reshape(-1, 9))[0]
    assert (far > 1e-5).mean() <= 5e-3


def test_render_panorama_cli_writes_jax_pngs(checkpoint, monkeypatch):
    """The port's panorama CLI through sys.argv and the JAX CLI on the
    same checkpoint and flags: the same three PNGs, decoded at most 1
    level apart on at most 0.1% of values."""
    from tests.test_torch_offline import _close_u8
    flags = ["--pano_h", "8", "--pano_w", "16"]
    port = checkpoint.run("port", render_panorama_cli.main, flags,
                          monkeypatch)
    ref = checkpoint.run("jax", jpano_cli.main, flags, monkeypatch)
    for sub, shape in (("rgb", (8, 16, 3)), ("opacity", (8, 16)),
                       ("mask", (8, 16))):
        t = read_png(port / "panorama" / sub / "0.png")
        assert t.shape == shape
        _close_u8(t, read_png(ref / "panorama" / sub / "0.png"), sub)
    assert read_png(port / "panorama" / "opacity" / "0.png").any()
