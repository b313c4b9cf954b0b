"""The NGP radiance field on the brick and hash encoders (counterpart of
ingp_tpu/models/ngp.py).

Parameters are a plain tree of tensors with the JAX package's structure:

  params = {
    "density_table": brick table (bricks, row_width) or hash table
                     (total_rows, F), f32,
    "rgb_table":     the same for the colour features,
    (encoder "fused": one "grid_table" (bricks, row_width) in their
     place, each lattice point's density_F then rgb_F features in one
     row, `fused_brick_cfg`)
    "xyz_net":  MLP L*F -> 128 -> 1 (softplus hidden),
    "rgb_net":  MLP (16 + L*F [+ embed_a_len]) -> 128 -> 3,
    "norm_net": MLP L*F -> 32 -> 3,
    "sem_net":  MLP L*F -> 32 -> classes,
    ["skybox_net"]: MLP 9 -> 32 -> 3 (use_skybox),
    ["tonemapper_r/g/b"]: MLP 1 -> 64 -> 1 (rgb_act "none", HDR),
  }

`params_from_numpy` / `params_to_numpy` carry an `ngp_init` pytree of
the JAX package across: the brick tables keep the stored row layout,
the MLP layers the `mlp_init` order, and the hash tables, which the JAX
package keeps feature-major (F, total_rows), are transposed to the
port's row-major (total_rows, F) and back (`hash_layout`; also the
transient mask's table, models/implicit_mask.py).

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
from ..ops.activations import trunc_exp
from ..ops.sh import sh_encode, sh_encode_cm
from ..ops.streambrick import streambrick_encode, streambrick_encode_grad
from .mlp import dot, mlp_apply, mlp_apply_cm, mlp_init, round_to


def per_level_scale_for(scene_scale: float, n_levels: int = 16,
                        base_resolution: int = 16,
                        max_resolution_factor: float = 2048.0) -> float:
    """Growth factor b = exp(ln(2048*scale/Nmin)/(L-1))."""
    return float(np.exp(np.log(max_resolution_factor * scene_scale /
                               base_resolution) / (n_levels - 1)))


@dataclasses.dataclass(frozen=True)
class NGPConfig:
    """Model hyperparameters; the fields and defaults of ingp_tpu's
    NGPConfig except encode_remat (a JAX rematerialisation policy).
    encoder: "hash", "brick" or "fused" (the brick layout with the
    density and rgb features of a lattice point in one table row).
    stream_seg_head / stream_head_frac: the tight tile class at the head
    of each chunk of a stream sorted by per-ray kept count;
    stream_caps: per-level caps measured by the trainer's
    auto-calibration, replacing the formula's (None: the formula)."""
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
    stream_seg_head: int = 20
    stream_head_frac: float = 0.0
    stream_caps: tuple | None = None

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
    def fused_brick_cfg(self) -> BrickGridConfig:
        """One table of [density_F | rgb_F] features per lattice point,
        on the rgb table's levels and brick count."""
        assert self.density_L == self.rgb_L, \
            "fused encoder requires density_L == rgb_L"
        return self._brick_cfg(self.rgb_L, self.density_F + self.rgb_F,
                               self.rgb_log2T)

    @property
    def rgb_in_dim(self) -> int:
        d = self.sh_degree ** 2 + self.rgb_L * self.rgb_F
        return d + (self.embed_a_len if self.embed_a else 0)

    @property
    def dtype(self) -> torch.dtype:
        return to_torch_dtype(self.compute_dtype)


def _check_supported(cfg: NGPConfig):
    if cfg.encoder not in ("brick", "hash", "fused"):
        raise ValueError(f"unknown encoder {cfg.encoder!r}")


def ngp_init(cfg: NGPConfig, key, device=None):
    """Random parameters (tables uniform in +-1e-4, MLPs as mlp_init),
    drawn from the PRNG key (core/prng.py) as the JAX package's ngp_init
    draws them: the same values for the same key."""
    _check_supported(cfg)
    LFd = cfg.density_L * cfg.density_F
    LFr = cfg.rgb_L * cfg.rgb_F
    keys = prng.split(key, 10)
    if cfg.encoder == "fused":
        tables = {"grid_table": brickgrid_init(cfg.fused_brick_cfg, keys[0],
                                               device)}
    else:
        init, dcfg, rcfg = (
            (hashgrid_init, cfg.density_grid_cfg, cfg.rgb_grid_cfg)
            if cfg.encoder == "hash" else
            (brickgrid_init, cfg.density_brick_cfg, cfg.rgb_brick_cfg))
        tables = {"density_table": init(dcfg, keys[0], device),
                  "rgb_table": init(rcfg, keys[2], device)}
    params = {
        **tables,
        "xyz_net": mlp_init((LFd, 128, 1), keys[1], device),
        "rgb_net": mlp_init((cfg.rgb_in_dim, 128, 3), keys[3], device),
        "norm_net": mlp_init((LFr, 32, 3), keys[4], device),
        "sem_net": mlp_init((LFr, 32, cfg.classes), keys[5], device),
    }
    if cfg.use_skybox:
        params["skybox_net"] = mlp_init((cfg.skybox_sh_degree ** 2, 32, 3),
                                        keys[6], device)
    if cfg.rgb_act == "none":
        for i, ch in enumerate("rgb"):
            params[f"tonemapper_{ch}"] = mlp_init((1, 64, 1), keys[7 + i],
                                                  device)
    return params


HASH_TABLES = ("density_table", "rgb_table")
MASK_TABLE = ("msk", "table")


def hash_layout(tree, cfg: NGPConfig | None):
    """tree with its hash tables transposed between the JAX package's
    (F, total_rows) and the port's (total_rows, F) layout: the
    HASH_TABLES leaves, at any depth, when cfg's encoder is "hash", and
    the transient mask's table (the "table" leaf of a "msk" subtree)
    whatever cfg says. Its own inverse, for params and for Adam moments
    alike."""
    model_hash = cfg is not None and cfg.encoder == "hash"

    def walk(t, path=()):
        if isinstance(t, dict):
            return {k: walk(v, path + (k,)) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [walk(v, path + (i,)) for i, v in enumerate(t)]
        if path[-2:] == MASK_TABLE or (model_hash and path
                                       and path[-1] in HASH_TABLES):
            return t.T
        return t
    return walk(tree)


def tree_map(fn, tree):
    """fn on every leaf of a nested dict / list tree (tuples become
    lists)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def params_from_numpy(tree, device=None, cfg: NGPConfig | None = None):
    """ingp_tpu `ngp_init` pytree (numpy leaves) -> the port's tree (hash
    tables transposed where cfg says the encoder is "hash", the mask's
    table always)."""
    return tree_map(
        lambda a: torch.as_tensor(np.array(a, order="C"), device=device),
        hash_layout(tree, cfg))


def params_to_numpy(tree, cfg: NGPConfig | None = None):
    """Inverse of params_from_numpy: copies, which later in-place
    updates of the tensors (the optimiser's) leave as they are."""
    return tree_map(
        lambda t: np.array(t.detach().cpu().numpy(), order="C"),
        hash_layout(tree, cfg))


def _normalize_coords(cfg: NGPConfig, x):
    """[-scale, scale]^3 -> [0, 1]^3."""
    return (x + cfg.scale) / (2.0 * cfg.scale)


def _storage_dt(cfg: NGPConfig):
    return None if cfg.table_dtype == "float32" else cfg.table_dtype


def _use_stream(cfg: NGPConfig, stream) -> bool:
    """stream: False, True (a ray-contiguous compact stream) or "sorted"
    (also sorted by per-ray kept count, which arms the head class)."""
    return (bool(stream) and cfg.stream_dedup
            and cfg.encoder in ("brick", "fused"))


def _stream_kwargs(cfg: NGPConfig, bcfg: BrickGridConfig, stream):
    """The stream encoder's settings: the head class only on a sorted
    stream (on an unsorted one its tight caps would overflow), the
    measured caps only on an encoder with their level count (they come
    from the rgb table's levels)."""
    sorted_ = stream == "sorted"
    caps = cfg.stream_caps
    if caps is not None and len(caps) != bcfg.n_levels:
        caps = None
    return dict(tile=cfg.stream_tile, chunk=cfg.encode_chunk,
                storage_dtype=_storage_dt(cfg), slack=cfg.stream_slack,
                seg_est=cfg.stream_seg, direct_frac=cfg.stream_direct_frac,
                seg_head=cfg.stream_seg_head if sorted_ else 0,
                head_frac=cfg.stream_head_frac if sorted_ else 0.0,
                caps_override=caps)


def _split_fused(cfg: NGPConfig, feats):
    """(N, L*(Fd+Fr)) level-major fused features -> (density (N, L*Fd),
    rgb (N, L*Fr))."""
    N = feats.shape[0]
    L, Fd, Fr = cfg.rgb_L, cfg.density_F, cfg.rgb_F
    f = feats.reshape(N, L, Fd + Fr)
    return f[:, :, :Fd].reshape(N, L * Fd), f[:, :, Fd:].reshape(N, L * Fr)


def _brick_encode(cfg: NGPConfig, bcfg, table, u_cm, stream):
    """Stream-dedup or per-sample brick encode of (3, N) coords."""
    if _use_stream(cfg, stream):
        return streambrick_encode(bcfg, table, u_cm,
                                  **_stream_kwargs(cfg, bcfg, stream))
    return brickgrid_encode(bcfg, table, u_cm, chunk=cfg.encode_chunk,
                            storage_dtype=_storage_dt(cfg), x_cm=True)


def _encode(cfg: NGPConfig, which, params, u_cm, stream):
    """Hash, stream-dedup or per-sample brick features of (3, N) coords
    for `which` ("density" or "rgb"); the fused encoder reads its one
    table and keeps that half of each level's features."""
    if cfg.encoder == "fused":
        feats = _brick_encode(cfg, cfg.fused_brick_cfg, params["grid_table"],
                              u_cm, stream)
        return _split_fused(cfg, feats)[int(which == "rgb")]
    table = params[f"{which}_table"]
    if cfg.encoder == "hash":
        return hashgrid_encode(getattr(cfg, f"{which}_grid_cfg"), table,
                               u_cm, storage_dtype=_storage_dt(cfg),
                               x_cm=True)
    return _brick_encode(cfg, getattr(cfg, f"{which}_brick_cfg"), table,
                         u_cm, stream)


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
    h = _encode(cfg, "density", params, u, stream)
    raw, _ = _density_mlp(cfg, params, h)
    return nnf.softplus(raw)


def ngp_sigma(cfg: NGPConfig, params, x):
    """Density only, row-major: x (N, 3) world coords -> (N,) sigma."""
    return ngp_sigma_cm(cfg, params, x.T)


def ngp_grad_cm(cfg: NGPConfig, params, x_cm, stream=False):
    """(sigmas (N,), feat_rgb (N, L*F), d sigma/dx (3, N)): the analytic
    trilerp jacobian of the density features chained with the density
    MLP's vjp. The fused encoder gives the density features, their
    jacobian (the window [0, density_F) of each level) and the rgb
    features in one pass."""
    _check_supported(cfg)
    u = _normalize_coords(cfg, x_cm)
    feat_rgb = None
    if cfg.encoder == "hash":
        feats, jac = hashgrid_encode_grad(
            cfg.density_grid_cfg, params["density_table"], u,
            storage_dtype=_storage_dt(cfg), x_cm=True)
    else:
        fused = cfg.encoder == "fused"
        bcfg = cfg.fused_brick_cfg if fused else cfg.density_brick_cfg
        table = params["grid_table" if fused else "density_table"]
        jac_hi = cfg.density_F if fused else None
        if _use_stream(cfg, stream):
            feats, jac = streambrick_encode_grad(
                bcfg, table, u, jac_lo=0, jac_hi=jac_hi,
                **_stream_kwargs(cfg, bcfg, stream))
        else:
            feats, jac = brickgrid_encode_grad(
                bcfg, table, u, chunk=cfg.encode_chunk, jac_lo=0,
                jac_hi=jac_hi, storage_dtype=_storage_dt(cfg), x_cm=True)
        if fused:
            feats, feat_rgb = _split_fused(cfg, feats)
    raw, pre = _density_mlp(cfg, params, feats)
    sigmas = nnf.softplus(raw)
    dfeat = _density_mlp_vjp(cfg, params, pre, torch.sigmoid(raw))
    grads = torch.einsum("dnf,nf->dn", jac, dfeat) / (2.0 * cfg.scale)
    if feat_rgb is None:
        feat_rgb = _encode(cfg, "rgb", params, u, stream)
    return sigmas, feat_rgb, grads


def _safe_normalize(v, eps=1e-6, axis=-1):
    """v / sqrt(|v|^2 + eps^2) along axis."""
    v32 = v.float()
    return v32 * torch.rsqrt((v32 * v32).sum(axis, keepdim=True) + eps * eps)


def ngp_grad(cfg: NGPConfig, params, x):
    """Row-major ngp_grad_cm: x (N, 3) -> (sigmas (N,), feat_rgb
    (N, L*F), d sigma/dx (N, 3))."""
    sigmas, feat_rgb, grads = ngp_grad_cm(cfg, params, x.T)
    return sigmas, feat_rgb, grads.T


def ngp_rgb_feat(cfg: NGPConfig, params, x):
    """RGB table features (N, L*F) at world coords x (N, 3)."""
    _check_supported(cfg)
    return _encode(cfg, "rgb", params, _normalize_coords(cfg, x.T), False)


def ngp_density(cfg: NGPConfig, params, x, return_feat=False):
    """sigma (N,) at x (N, 3), with the rgb features when return_feat."""
    sigmas = ngp_sigma(cfg, params, x)
    if return_feat:
        return sigmas, ngp_rgb_feat(cfg, params, x)
    return sigmas


def log_radiance_to_rgb(cfg: NGPConfig, params, log_radiances,
                        exposure=None):
    """HDR tonemapping: per channel, a 64-unit MLP (relu, sigmoid out) on
    log-radiance (N, 3) + log exposure ((N, 1) or broadcastable; none:
    0) -> rgb (N, 3), in the compute dtype."""
    log_exp = torch.log(exposure) if exposure is not None else 0.0
    return torch.cat([mlp_apply(params[f"tonemapper_{ch}"],
                                log_radiances[:, i:i + 1] + log_exp,
                                "relu", "sigmoid", cfg.dtype)
                      for i, ch in enumerate("rgb")], 1)


def _rgb_net_cm(cfg: NGPConfig, params, dsh_cm, feat, embedding_a,
                out_act):
    """rgb_net with its first layer split into the SH block (channel-
    major (16, N) input), the feature block ((N, L*F) input) and, with
    embed_a, the appearance block ((N, embed_a_len) input), each in the
    compute dtype with f32 sums. Returns (3, N)."""
    layers = params["rgb_net"]
    cd = cfg.dtype
    d2 = cfg.sh_degree ** 2
    lf = cfg.rgb_L * cfg.rgb_F
    w1 = layers[0]["w"]
    h = dot(dsh_cm.T, w1[:d2], cd) + dot(feat, w1[d2:d2 + lf], cd)
    if cfg.embed_a:
        h = h + dot(embedding_a, w1[d2 + lf:], cd)
    h = torch.relu(h + layers[0]["b"].float())
    return mlp_apply(layers[1:], h, "relu", out_act, cd).T


def _forward_heads(cfg: NGPConfig, params, sigmas, feat_rgb, grads, d_cm,
                   embedding_a=None, exposure=None, output_radiance=False,
                   stop_header_grads=False):
    """Normal, semantic and rgb heads on the density/encode front half.
    With rgb_act "none" the rgb head gives log radiance, returned as
    radiance (trunc_exp) with output_radiance, else tonemapped at the
    per-sample exposure."""
    cd = cfg.dtype
    normals_raw = -_safe_normalize(grads, axis=0)
    feat_h = feat_rgb.detach() if stop_header_grads else feat_rgb
    normals_pred = -_safe_normalize(
        mlp_apply_cm(params["norm_net"], feat_h, "relu", "none", cd),
        axis=0)
    semantic = torch.softmax(
        mlp_apply_cm(params["sem_net"], feat_h, "relu", "none", cd), 0)
    dsh_cm = sh_encode_cm(_safe_normalize(d_cm, axis=0), cfg.sh_degree)
    out_act = "sigmoid" if cfg.rgb_act == "sigmoid" else "none"
    rgbs = _rgb_net_cm(cfg, params, dsh_cm, feat_rgb, embedding_a, out_act)
    if cfg.rgb_act == "none":
        rgbs = trunc_exp(rgbs) if output_radiance else \
            log_radiance_to_rgb(cfg, params, rgbs.T, exposure).T
    return sigmas, rgbs, normals_raw, normals_pred, semantic


def ngp_forward_cm(cfg: NGPConfig, params, x_cm, d_cm, embedding_a=None,
                   exposure=None, output_radiance=False,
                   stop_header_grads=False, stream=False):
    """Full per-sample forward, channel-major: x_cm, d_cm (3, N), the
    appearance codes embedding_a (N, embed_a_len) and the exposure
    (N, 1) per sample -> (sigmas (N,), rgbs (3, N), normals_raw (3, N),
    normals_pred (3, N), semantic (classes, N)). stop_header_grads
    detaches the normal and semantic heads' input features."""
    sigmas, feat_rgb, grads = ngp_grad_cm(cfg, params, x_cm, stream=stream)
    return _forward_heads(cfg, params, sigmas, feat_rgb, grads, d_cm,
                          embedding_a, exposure, output_radiance,
                          stop_header_grads)


def ngp_forward(cfg: NGPConfig, params, x, d, embedding_a=None,
                exposure=None, output_radiance=False,
                stop_header_grads=False):
    """Row-major ngp_forward_cm: x, d (N, 3) -> per-sample (N, C)
    outputs (sigmas (N,))."""
    sigmas, rgbs, nraw, npred, sem = ngp_forward_cm(
        cfg, params, x.T, d.T, embedding_a=embedding_a, exposure=exposure,
        output_radiance=output_radiance,
        stop_header_grads=stop_header_grads)
    return sigmas, rgbs.T, nraw.T, npred.T, sem.T


def ngp_forward_skybox(cfg: NGPConfig, params, d):
    """Skybox colour (N, 3) of view directions d (N, 3): SH of degree
    skybox_sh_degree through skybox_net (sigmoid out, or none with
    rgb_act "none"), in the compute dtype."""
    dsh = sh_encode(_safe_normalize(d), cfg.skybox_sh_degree)
    out_act = "sigmoid" if cfg.rgb_act == "sigmoid" else "none"
    return mlp_apply(params["skybox_net"], dsh, "relu", out_act, cfg.dtype)
