"""The NGP radiance field on the brick and hash encoders (counterpart of
ingp_tpu/models/ngp.py, forward).

Parameters are a plain tree of tensors with the JAX package's structure:

  params = {
    "density_table": brick table (bricks, row_width) or hash table
                     (total_rows, F), f32,
    "rgb_table":     the same for the colour features,
    "xyz_net":  MLP L*F -> 128 -> 1 (softplus hidden),
    "rgb_net":  MLP (16 + L*F) -> 128 -> 3,
    "norm_net": MLP L*F -> 32 -> 3,
    "sem_net":  MLP L*F -> 32 -> classes,
  }

`params_from_numpy` / `params_to_numpy` carry an `ngp_init` pytree of
the JAX package across: the brick tables keep the stored row layout,
the MLP layers the `mlp_init` order, and the hash tables, which the JAX
package keeps feature-major (F, total_rows), are transposed to the
port's row-major (total_rows, F) and back (`hash_layout`).

The density MLP's vector-Jacobian product (for the density gradient
that gives the raw normals) is written out by hand: softplus' = sigmoid
and the transposed weights, with the JAX package's rounding points in a
low-precision compute dtype.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as nnf

from ..core import prng
from ..core.cascade import n_cascades
from ..ops.brickgrid import (BrickGridConfig, brickgrid_encode,
                             brickgrid_encode_grad, brickgrid_init)
from ..ops.gather import to_torch_dtype
from ..ops.hashgrid import (HashGridConfig, hashgrid_encode,
                            hashgrid_encode_grad, hashgrid_init)
from ..ops.sh import sh_encode_cm
from ..ops.streambrick import streambrick_encode, streambrick_encode_grad
from .mlp import _ACTS, dot, mlp_apply_cm, mlp_init, round_to


def per_level_scale_for(scene_scale: float, n_levels: int = 16,
                        base_resolution: int = 16,
                        max_resolution_factor: float = 2048.0) -> float:
    """Growth factor b = exp(ln(2048*scale/Nmin)/(L-1))."""
    return float(np.exp(np.log(max_resolution_factor * scene_scale /
                               base_resolution) / (n_levels - 1)))


@dataclasses.dataclass(frozen=True)
class NGPConfig:
    """Model hyperparameters; the fields and defaults of ingp_tpu's
    NGPConfig except encode_remat (a JAX rematerialisation policy) and
    stream_seg_head / stream_head_frac / stream_caps (tile caps of the
    training step's sorted stream; the test render's stream is
    unsorted). The port runs encoder="brick" or "hash" with
    rgb_act="sigmoid" and no skybox / appearance embedding."""
    scale: float = 0.5
    rgb_act: str = "sigmoid"
    use_skybox: bool = False
    embed_a: bool = False
    embed_a_len: int = 12
    classes: int = 7
    grid_size: int = 128
    density_L: int = 16
    density_F: int = 8
    density_log2T: int = 19
    rgb_L: int = 16
    rgb_F: int = 8
    rgb_log2T: int = 21
    base_res: int = 16
    sh_degree: int = 4
    skybox_sh_degree: int = 3
    compute_dtype: str = "float32"
    encoder: str = "hash"
    table_dtype: str = "float32"
    encode_chunk: int = 16384
    stream_dedup: bool = False
    stream_tile: int = 256
    stream_slack: float = 1.5
    stream_direct_frac: float = 0.7
    stream_seg: int = 4

    @property
    def cascades(self) -> int:
        return n_cascades(self.scale)

    def _hash_cfg(self, L, F, log2T) -> HashGridConfig:
        return HashGridConfig(
            n_levels=L, n_features=F, log2_hashmap_size=log2T,
            base_resolution=self.base_res,
            per_level_scale=per_level_scale_for(self.scale, L,
                                                self.base_res))

    @property
    def density_grid_cfg(self) -> HashGridConfig:
        return self._hash_cfg(self.density_L, self.density_F,
                              self.density_log2T)

    @property
    def rgb_grid_cfg(self) -> HashGridConfig:
        return self._hash_cfg(self.rgb_L, self.rgb_F, self.rgb_log2T)

    def _brick_cfg(self, L, F, log2T) -> BrickGridConfig:
        return BrickGridConfig(
            n_levels=L, n_features=F, log2_bricks=max(log2T - 5, 8),
            base_resolution=self.base_res,
            per_level_scale=per_level_scale_for(self.scale, L,
                                                self.base_res))

    @property
    def density_brick_cfg(self) -> BrickGridConfig:
        return self._brick_cfg(self.density_L, self.density_F,
                               self.density_log2T)

    @property
    def rgb_brick_cfg(self) -> BrickGridConfig:
        return self._brick_cfg(self.rgb_L, self.rgb_F, self.rgb_log2T)

    @property
    def rgb_in_dim(self) -> int:
        d = self.sh_degree ** 2 + self.rgb_L * self.rgb_F
        return d + (self.embed_a_len if self.embed_a else 0)

    @property
    def dtype(self) -> torch.dtype:
        return to_torch_dtype(self.compute_dtype)


def _check_supported(cfg: NGPConfig):
    if cfg.encoder not in ("brick", "hash"):
        raise NotImplementedError(
            f"encoder {cfg.encoder!r} is not ported yet (brick and hash "
            f"only)")
    if cfg.use_skybox or cfg.embed_a or cfg.rgb_act != "sigmoid":
        raise NotImplementedError(
            "skybox, appearance embeddings and HDR tonemapping are not "
            "ported yet")


def ngp_init(cfg: NGPConfig, key, device=None):
    """Random parameters (tables uniform in +-1e-4, MLPs as mlp_init),
    drawn from the PRNG key (core/prng.py) as the JAX package's ngp_init
    draws them: the same values for the same key."""
    _check_supported(cfg)
    LFd = cfg.density_L * cfg.density_F
    LFr = cfg.rgb_L * cfg.rgb_F
    keys = prng.split(key, 10)
    if cfg.encoder == "hash":
        init, dcfg, rcfg = (hashgrid_init, cfg.density_grid_cfg,
                            cfg.rgb_grid_cfg)
    else:
        init, dcfg, rcfg = (brickgrid_init, cfg.density_brick_cfg,
                            cfg.rgb_brick_cfg)
    return {
        "density_table": init(dcfg, keys[0], device),
        "xyz_net": mlp_init((LFd, 128, 1), keys[1], device),
        "rgb_table": init(rcfg, keys[2], device),
        "rgb_net": mlp_init((cfg.rgb_in_dim, 128, 3), keys[3], device),
        "norm_net": mlp_init((LFr, 32, 3), keys[4], device),
        "sem_net": mlp_init((LFr, 32, cfg.classes), keys[5], device),
    }


HASH_TABLES = ("density_table", "rgb_table")


def hash_layout(tree, cfg: NGPConfig | None):
    """tree with its hash tables (the HASH_TABLES leaves, at any depth)
    transposed between the JAX package's (F, total_rows) and the port's
    (total_rows, F) layout, when cfg's encoder is "hash"; the same tree
    otherwise. Its own inverse, for params and for Adam moments alike."""
    if cfg is None or cfg.encoder != "hash":
        return tree

    def walk(t, key=None):
        if isinstance(t, dict):
            return {k: walk(v, k) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [walk(v) for v in t]
        return t.T if key in HASH_TABLES else t
    return walk(tree)


def params_from_numpy(tree, device=None, cfg: NGPConfig | None = None):
    """ingp_tpu `ngp_init` pytree (numpy leaves) -> the port's tree (hash
    tables transposed where cfg says the encoder is "hash")."""
    tree = hash_layout(tree, cfg)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v, device) for v in tree]
    return torch.as_tensor(np.array(tree, order="C"), device=device)


def params_to_numpy(tree, cfg: NGPConfig | None = None):
    """Inverse of params_from_numpy: copies, which later in-place
    updates of the tensors (the optimiser's) leave as they are."""
    tree = hash_layout(tree, cfg)
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_to_numpy(v) for v in tree]
    return np.array(tree.detach().cpu().numpy(), order="C")


def _normalize_coords(cfg: NGPConfig, x):
    """[-scale, scale]^3 -> [0, 1]^3."""
    return (x + cfg.scale) / (2.0 * cfg.scale)


def _storage_dt(cfg: NGPConfig):
    return None if cfg.table_dtype == "float32" else cfg.table_dtype


def _use_stream(cfg: NGPConfig, stream) -> bool:
    return bool(stream) and cfg.stream_dedup and cfg.encoder == "brick"


def _stream_kwargs(cfg: NGPConfig):
    return dict(tile=cfg.stream_tile, chunk=cfg.encode_chunk,
                storage_dtype=_storage_dt(cfg), slack=cfg.stream_slack,
                seg_est=cfg.stream_seg, direct_frac=cfg.stream_direct_frac)


def _encode(cfg: NGPConfig, which, table, u_cm, stream):
    """Hash, stream-dedup or per-sample brick encode of (3, N) coords on
    the `which` ("density" or "rgb") table."""
    if cfg.encoder == "hash":
        return hashgrid_encode(getattr(cfg, f"{which}_grid_cfg"), table,
                               u_cm, storage_dtype=_storage_dt(cfg),
                               x_cm=True)
    bcfg = getattr(cfg, f"{which}_brick_cfg")
    if _use_stream(cfg, stream):
        return streambrick_encode(bcfg, table, u_cm, **_stream_kwargs(cfg))
    return brickgrid_encode(bcfg, table, u_cm, chunk=cfg.encode_chunk,
                            storage_dtype=_storage_dt(cfg), x_cm=True)


def _density_mlp(cfg: NGPConfig, params, feats):
    """Density MLP on (N, L*F) features -> (raw (N,), pre-activations)."""
    layers = params["xyz_net"]
    cd = cfg.dtype
    h, pre = feats, []
    for i, lyr in enumerate(layers):
        z = dot(h, lyr["w"], cd) + lyr["b"].float()
        pre.append(z)
        h = nnf.softplus(z) if i < len(layers) - 1 else z
    return h[:, 0], pre


def _density_mlp_vjp(cfg: NGPConfig, params, pre, ct):
    """d raw / d feats applied to the cotangent ct (N,): transposed
    weights and softplus' = sigmoid, with the cotangent of each
    compute-dtype activation rounded to the compute dtype."""
    layers = params["xyz_net"]
    cd = cfg.dtype
    g = ct[:, None]
    for i in range(len(layers) - 1, -1, -1):
        if i < len(layers) - 1:
            g = g * torch.sigmoid(pre[i])
        g = round_to(g @ round_to(layers[i]["w"], cd).T, cd)
    return g


def ngp_sigma_cm(cfg: NGPConfig, params, x_cm, stream=False):
    """Density only: x_cm (3, N) world coords -> (N,) sigma."""
    _check_supported(cfg)
    u = _normalize_coords(cfg, x_cm)
    h = _encode(cfg, "density", params["density_table"], u, stream)
    raw, _ = _density_mlp(cfg, params, h)
    return nnf.softplus(raw)


def ngp_sigma(cfg: NGPConfig, params, x):
    """Density only, row-major: x (N, 3) world coords -> (N,) sigma."""
    return ngp_sigma_cm(cfg, params, x.T)


def ngp_grad_cm(cfg: NGPConfig, params, x_cm, stream=False):
    """(sigmas (N,), feat_rgb (N, L*F), d sigma/dx (3, N)): the analytic
    trilerp jacobian of the density features chained with the density
    MLP's vjp."""
    _check_supported(cfg)
    u = _normalize_coords(cfg, x_cm)
    table = params["density_table"]
    if cfg.encoder == "hash":
        feats, jac = hashgrid_encode_grad(
            cfg.density_grid_cfg, table, u, storage_dtype=_storage_dt(cfg),
            x_cm=True)
    elif _use_stream(cfg, stream):
        feats, jac = streambrick_encode_grad(cfg.density_brick_cfg, table, u,
                                             **_stream_kwargs(cfg))
    else:
        feats, jac = brickgrid_encode_grad(
            cfg.density_brick_cfg, table, u, chunk=cfg.encode_chunk,
            storage_dtype=_storage_dt(cfg), x_cm=True)
    raw, pre = _density_mlp(cfg, params, feats)
    sigmas = nnf.softplus(raw)
    dfeat = _density_mlp_vjp(cfg, params, pre, torch.sigmoid(raw))
    grads = torch.einsum("dnf,nf->dn", jac, dfeat) / (2.0 * cfg.scale)
    feat_rgb = _encode(cfg, "rgb", params["rgb_table"], u, stream)
    return sigmas, feat_rgb, grads


def _safe_normalize(v, eps=1e-6, axis=-1):
    """v / sqrt(|v|^2 + eps^2) along axis."""
    v32 = v.float()
    return v32 * torch.rsqrt((v32 * v32).sum(axis, keepdim=True) + eps * eps)


def _rgb_net_cm(cfg: NGPConfig, params, dsh_cm, feat):
    """rgb_net with its first layer split into the SH block (channel-
    major (16, N) input) and the feature block ((N, L*F) input).
    Returns (3, N)."""
    layers = params["rgb_net"]
    cd = cfg.dtype
    d2 = cfg.sh_degree ** 2
    lf = cfg.rgb_L * cfg.rgb_F
    w1 = layers[0]["w"]
    h = dot(dsh_cm.T, w1[:d2], cd) + dot(feat, w1[d2:d2 + lf], cd)
    h = torch.relu(h + layers[0]["b"].float())
    out = h
    for i, lyr in enumerate(layers[1:]):
        out = dot(out, lyr["w"], cd) + lyr["b"].float()
        out = torch.relu(out) if i < len(layers) - 2 else \
            _ACTS["sigmoid" if cfg.rgb_act == "sigmoid" else "none"](out)
    return out.T


def _forward_heads(cfg: NGPConfig, params, sigmas, feat_rgb, grads, d_cm):
    """Normal, semantic and rgb heads on the density/encode front half."""
    cd = cfg.dtype
    normals_raw = -_safe_normalize(grads, axis=0)
    normals_pred = -_safe_normalize(
        mlp_apply_cm(params["norm_net"], feat_rgb, "relu", "none", cd),
        axis=0)
    semantic = torch.softmax(
        mlp_apply_cm(params["sem_net"], feat_rgb, "relu", "none", cd), 0)
    dsh_cm = sh_encode_cm(_safe_normalize(d_cm, axis=0), cfg.sh_degree)
    rgbs = _rgb_net_cm(cfg, params, dsh_cm, feat_rgb)
    return sigmas, rgbs, normals_raw, normals_pred, semantic


def ngp_forward_cm(cfg: NGPConfig, params, x_cm, d_cm, stream=False):
    """Full per-sample forward, channel-major: x_cm, d_cm (3, N) ->
    (sigmas (N,), rgbs (3, N), normals_raw (3, N), normals_pred (3, N),
    semantic (classes, N))."""
    sigmas, feat_rgb, grads = ngp_grad_cm(cfg, params, x_cm, stream=stream)
    return _forward_heads(cfg, params, sigmas, feat_rgb, grads, d_cm)

