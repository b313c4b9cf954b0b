"""Offline rendering (counterpart of ingp_tpu/render/offline.py).

`render_for_test` loads a (slim) checkpoint unless it is handed a
system, renders every test pose, or the dataset's camera path with
`render_traj`, in chunks of `hparams.chunk_size` rays (`render_chunks`),
writes each frame's rgb / depth / normal / semantic PNGs and assembles
30 fps mp4 videos. A novel pose takes the mean appearance code of its
two nearest training cameras (`FrameEmbedding` "mean").

The videos go through an `ffmpeg` executable on PATH, fed raw rgb24
frames on its standard input with the JAX package's encoder settings
(imageio's: libx264, yuv420p, crf 25, sizes padded up to multiples of
16). Without one a line `video write skipped (<name>): ...` says so, as
the JAX package prints when its codec is missing; the frames' PNGs are
written either way.
"""
from __future__ import annotations

import os
import shutil
import subprocess
import tempfile

import numpy as np
import torch

from ..core.rays import get_rays
from ..data.image_io import resize_area, resize_nearest
from ..models.rendering import render_rays_test
from ..utils.frame_embedding import FrameEmbedding
from ..utils.vis import convert_normal, depth2img, save_image, semantic2img

VIDEO_FPS = 30
VIDEO_CRF = 25            # imageio's default quality 5 for libx264
VIDEO_BLOCK = 16          # imageio's macro_block_size


@torch.no_grad()
def render_chunks(model_cfg, render_cfg, params, bitfield, rays_o, rays_d,
                  chunk_size=131072, embedding_a=None, block_table=None):
    """Test render of (N, 3) rays (tensors or arrays; moved to the
    bitfield's device) in chunks of chunk_size rays. A tail chunk after
    the first is padded to chunk_size by repeating its last ray. With
    embedding_a ((1, L) or (L,)) every ray takes that appearance code.
    Returns render_rays_test's outputs concatenated over the chunks
    (tensors on the device), "total_samples" summed to an int."""
    dev = bitfield.device
    rays_o = torch.as_tensor(rays_o, device=dev)
    rays_d = torch.as_tensor(rays_d, device=dev)
    if embedding_a is not None:
        embedding_a = torch.as_tensor(embedding_a, device=dev
                                      ).reshape(1, -1).float()
    n = rays_o.shape[0]
    outs = []
    for i in range(0, n, chunk_size):
        ro, rd = rays_o[i:i + chunk_size], rays_d[i:i + chunk_size]
        pad = 0
        if ro.shape[0] < chunk_size and i > 0:
            pad = chunk_size - ro.shape[0]
            ro = torch.cat([ro, ro[-1:].expand(pad, 3)])
            rd = torch.cat([rd, rd[-1:].expand(pad, 3)])
        m = ro.shape[0]
        res = render_rays_test(
            model_cfg, render_cfg, params, bitfield, ro.contiguous(),
            rd.contiguous(), embedding_a=None if embedding_a is None
            else embedding_a.expand(m, -1), block_table=block_table)
        if pad:
            res = {k: v[:-pad] if v.ndim >= 1 and v.shape[0] == m else v
                   for k, v in res.items()}
        outs.append(res)
    merged = {k: torch.cat([o[k] for o in outs], 0)
              for k in outs[0] if k != "total_samples"}
    merged["total_samples"] = sum(int(o["total_samples"]) for o in outs)
    return merged


def _load_last(system, hparams):
    """The run's `last` checkpoint, else its `last_slim`, into system."""
    ckpt_dir = os.path.join("ckpts", hparams.dataset_name, hparams.exp_name)
    for name in ("last", "last_slim"):
        path = os.path.join(ckpt_dir, name)
        if os.path.exists(path):
            system.load(path)
            return


def _check_aa(aa, n_rays, w, h):
    """The rays of a frame must be the factor's upscaled grid."""
    rw, rh = int(w * aa), int(h * aa)
    if n_rays != rw * rh:
        raise ValueError(
            f"anti_aliasing_factor {aa}: the test split casts {n_rays} "
            f"rays a frame, not the {rw}x{rh} that the factor renders; "
            f"NeRFSystem builds its datasets from root_dir and downsample "
            f"alone, so their directions stay at {w}x{h} (as in the JAX "
            f"package, whose reshape fails there). Build the datasets "
            f"with anti_aliasing_factor and pass system=")


def _downsample(res, aa, w, h):
    """Render-size outputs -> (w, h): area rule, semantics nearest."""
    rw, rh = int(w * aa), int(h * aa)
    for k in ("rgb", "depth", "normal_pred", "semantic"):
        if k in res:
            img = res[k].reshape((rh, rw) + res[k].shape[1:]
                                 ).astype(np.float32)
            resize = resize_nearest if k == "semantic" else resize_area
            res[k] = resize(img, (w, h)).reshape(h * w, -1).squeeze()
    return res


def render_for_test(hparams, system=None, device=None):
    """Render the test split (or its camera path) into
    results/<dataset_name>/<exp_name>: %05d_rgb.png, _depth.png,
    _normal.png, _semantic.png as render_rgb (on where hparams has no
    such field), render_depth, render_normal and render_semantic ask,
    and their mp4 videos unless hparams.no_save_test. system: a
    NeRFSystem to render (default: one built from hparams on `device`
    with the run's last checkpoint).
    Raises ValueError, before rendering, when anti_aliasing_factor > 1
    and the test split's rays are not the factor's upscaled grid.
    Returns the output directory."""
    if system is None:
        from ..training.trainer import NeRFSystem
        system = NeRFSystem(hparams, device=device)
        _load_last(system, hparams)
    dev = system.device
    model_cfg = system.model_cfg
    render_cfg = system.render_cfg_test
    params = system.params["model"]
    bitfield = system.grid["bitfield"]
    block_table = system.grid.get("block_table")
    dataset = system.test_dataset
    w, h = dataset.img_wh

    frame_emb = None
    if hparams.embed_a:
        frame_emb = FrameEmbedding(system.params["embedding_a"],
                                   system.train_dataset.poses)

    traj = getattr(dataset, "render_traj_rays", None) \
        if getattr(hparams, "render_traj", False) else None
    n_frames = len(traj) if traj is not None else len(dataset.poses)
    aa = getattr(hparams, "anti_aliasing_factor", 1.0)
    if aa > 1.0 and n_frames:
        _check_aa(aa, len(traj[0]) if traj is not None
                  else len(dataset.directions), w, h)

    out_dir = os.path.join("results", hparams.dataset_name, hparams.exp_name)
    os.makedirs(out_dir, exist_ok=True)
    directions = torch.as_tensor(dataset.directions, device=dev)
    frames = {"rgb": [], "depth": [], "normal": [], "semantic": []}
    for i in range(n_frames):
        if traj is not None:
            rays = torch.as_tensor(traj[i], device=dev)
            rays_o, rays_d = rays[:, :3], rays[:, 3:6]
            pose = None
        else:
            pose = dataset.poses[i]
            rays_o, rays_d = get_rays(directions,
                                      torch.as_tensor(pose, device=dev))
        emb = None
        if frame_emb is not None:
            emb = frame_emb(pose if pose is not None
                            else system.train_dataset.poses[0], mode="mean")
        res = render_chunks(model_cfg, render_cfg, params, bitfield, rays_o,
                            rays_d, hparams.chunk_size, embedding_a=emb,
                            block_table=block_table)
        res = {k: v.cpu().numpy() for k, v in res.items()
               if torch.is_tensor(v)}
        if aa > 1.0:
            res = _downsample(res, aa, w, h)

        def save(img, tag):
            save_image(img, os.path.join(out_dir, f"{i:05d}_{tag}.png"))
        rgb = np.clip(res["rgb"].reshape(h, w, 3), 0, 1)
        if getattr(hparams, "render_rgb", True):
            save(rgb, "rgb")
            frames["rgb"].append((rgb * 255).astype(np.uint8))
        if getattr(hparams, "render_depth", False):
            dimg = depth2img(res["depth"].reshape(h, w),
                             scale=2 * hparams.scale)[..., ::-1]
            save(dimg / 255.0, "depth")
            frames["depth"].append(dimg)
        if getattr(hparams, "render_normal", False):
            nrm = res["normal_pred"].reshape(h, w, 3)
            if pose is not None:
                nrm = convert_normal(nrm, pose)
            nimg = np.clip((nrm + 1) / 2, 0, 1)
            save(nimg, "normal")
            frames["normal"].append((nimg * 255).astype(np.uint8))
        if getattr(hparams, "render_semantic", False):
            simg = semantic2img(res["semantic"].reshape(h, w),
                                hparams.num_classes)[..., ::-1]
            save(simg / 255.0, "semantic")
            frames["semantic"].append(simg)

    if not getattr(hparams, "no_save_test", False):
        _write_videos(out_dir, frames)
    return out_dir


def _ffmpeg_command(ffmpeg, path, w, h, fps):
    """imageio's ffmpeg writer command for (h, w) rgb24 frames on stdin."""
    cmd = [ffmpeg, "-y", "-f", "rawvideo", "-vcodec", "rawvideo", "-s",
           f"{w}x{h}", "-pix_fmt", "rgb24", "-r", f"{fps:.02f}", "-i", "-",
           "-an", "-vcodec", "libx264", "-pix_fmt", "yuv420p", "-crf",
           str(VIDEO_CRF), "-v", "warning"]
    bw = -(-w // VIDEO_BLOCK) * VIDEO_BLOCK
    bh = -(-h // VIDEO_BLOCK) * VIDEO_BLOCK
    if (bw, bh) != (w, h):
        cmd += ["-vf", f"scale={bw}:{bh}"]
    return cmd + [path]


def _write_video(ffmpeg, path, imgs, fps):
    """Encode uint8 (h, w, 3) frames into path; raises RuntimeError with
    ffmpeg's messages when it fails."""
    h, w = imgs[0].shape[:2]
    with tempfile.TemporaryFile() as err:
        proc = subprocess.Popen(_ffmpeg_command(ffmpeg, path, w, h, fps),
                                stdin=subprocess.PIPE,
                                stdout=subprocess.DEVNULL, stderr=err)
        try:
            for img in imgs:
                proc.stdin.write(np.ascontiguousarray(img, np.uint8)
                                 .tobytes())
        except BrokenPipeError:
            pass
        finally:
            proc.stdin.close()
            rc = proc.wait()
        if rc != 0:
            err.seek(0)
            msg = err.read().decode(errors="replace").strip()
            raise RuntimeError(f"ffmpeg exited with {rc}: {msg[-500:]}")


def _write_videos(out_dir, frames, fps=VIDEO_FPS):
    """<name>.mp4 in out_dir of each frame list longer than one frame."""
    ffmpeg = shutil.which("ffmpeg")
    for name, imgs in frames.items():
        if len(imgs) <= 1:
            continue
        path = os.path.join(out_dir, f"{name}.mp4")
        if ffmpeg is None:
            print(f"video write skipped ({name}): no ffmpeg executable on "
                  f"PATH to encode {path} (libx264)", flush=True)
            continue
        try:
            _write_video(ffmpeg, path, imgs, fps)
        except (OSError, RuntimeError) as e:
            print(f"video write skipped ({name}): {e}", flush=True)
