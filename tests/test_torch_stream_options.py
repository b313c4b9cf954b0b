"""Port parity of the stream encoder's options against ingp_tpu on CPU:
the tile classes (the sorted head class, the caps override with its
monotone clamp), `run_count_quantiles`, the encodes with each option
(the JAX grouped path through the Pallas interpreter, and the per-level
plan where JAX leaves its grouped path: a tile that is no multiple of
128, rows of other than 32*F lanes), one f32 training step with
`stream_sort=False`, the cap auto-calibration's adopted caps on the same
run counts as JAX's `_maybe_grow_stream_caps`, the caps' checkpoint round
trip, and `train.main` with each of the four options.

Tolerances: the encodes at test_torch_stream.py's (features rtol 1e-5
and 1e-5 absolute, corner values O(0.1); the jacobian, which carries
the level scale, 1e-3 absolute); the step at test_torch_train.py's."""
from types import SimpleNamespace

import numpy as np
import jax
import pytest
import torch

from ingp_tpu.models import ngp as jngp
from ingp_tpu.ops import streambrick as js
from ingp_tpu.ops.brickgrid import BrickGridConfig as JCfg, brickgrid_init
from ingp_tpu.training import trainer as jt

from ingp_tpu_torch import train as train_cli
from ingp_tpu_torch.data.synthetic import SyntheticDataset
from ingp_tpu_torch.models import ngp as tngp
from ingp_tpu_torch.ops import streambrick as ts
from ingp_tpu_torch.ops.brickgrid import BrickGridConfig as TCfg
from ingp_tpu_torch.training import trainer as tt
from ingp_tpu_torch.utils import ckpt as tckpt
from tests._torch_threads import one_torch_thread  # noqa: F401
from tests.test_torch_stream import _jax_grouped, ray_stream
from tests.test_torch_train_variants import check_step

ARGS = dict(n_levels=8, n_features=4, log2_bricks=10, base_resolution=16,
            per_level_scale=1.45)
JCFG, TCFG = JCfg(**ARGS), TCfg(**ARGS)
BENCH = dict(n_levels=16, n_features=8, log2_bricks=16,
             per_level_scale=1.3819)


def T(a):
    return torch.as_tensor(np.array(a))


def N(a):
    return np.asarray(a)


@pytest.mark.parametrize("T_,seg_head,head_frac,caps", [
    (768, 20, 0.5, None),           # the bench's chunk: 384 head tiles
    (16, 20, 0.5, None),            # the smallest chunk with a head
    (15, 20, 0.5, None),            # T < 16: one class
    (16, 20, 0.05, None),           # an empty head: one class
    (64, 0, 0.5, None),             # no seg_head: one class
    (64, 8, 0.99, None),            # the head all but 8 tiles
    (32, 20, 0.5, (7, 3, 12, 12, 40, 9, 300, 256, 1, 80, 90, 100, 130, 180,
                   250, 256)),      # the override, clamped monotone
])
def test_tile_classes_match(T_, seg_head, head_frac, caps):
    jc, tc = JCfg(**BENCH), TCfg(**BENCH)
    for slack, seg in ((1.5, 4), (1.2, 8)):
        ref = js._tile_classes(jc, 256, T_, slack, seg, seg_head, head_frac,
                               0.7, caps)
        assert ts._tile_classes(tc, 256, T_, slack, seg, seg_head,
                                head_frac, 0.7, caps) == ref
    if T_ == 768 and caps is None:
        assert [c[2] for c in ref] == [384, 384]


@pytest.mark.parametrize("tile,q", [(256, 0.995), (64, 0.5), (5000, 0.995)])
def test_run_count_quantiles_match(tile, q):
    x = ray_stream(5, n_rays=200)
    ref = js.run_count_quantiles(JCFG, x, tile, q)
    got = ts.run_count_quantiles(TCFG, T(x), tile, q)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(N(got), N(ref))
    if tile < x.shape[1]:
        assert N(got).max() > 0


# (option kwargs, stream): the head class on a stream of two classes,
# the override (small caps, so that runs overflow at them), the per-level
# plan (tile 192: JAX leaves its grouped path and plans each level at its
# own cap), the per-level plan with an override on random points (every
# level overflows at its exact cap, not at an aligned group cap)
OPTIONS = {
    "head class": (dict(seg_head=20, head_frac=0.5, chunk=4096), "rays"),
    "caps override": (dict(caps_override=(5, 9, 3, 20, 40, 60, 100, 200)),
                      "rays"),
    "per level": (dict(tile=192), "rays"),
    "per level, overflow": (dict(tile=192, caps_override=(
        9, 9, 13, 20, 30, 60, 100, 150)), "random"),
}


@pytest.mark.parametrize("option", list(OPTIONS))
def test_stream_option_encode_matches(monkeypatch, option):
    kw, stream = OPTIONS[option]
    kw = {"tile": 256, **kw}
    table = N(brickgrid_init(jax.random.PRNGKey(7), JCFG)) * 1e3
    x = ray_stream(8, n_rays=300) if stream == "rays" else \
        np.random.default_rng(9).uniform(0, 1, (3, 1500)).astype(np.float32)
    _jax_grouped(monkeypatch)
    try:
        fj, jj = js.streambrick_encode_grad(JCFG, table, x, **kw)
    finally:
        js.streambrick_encode.clear_cache()
        js.streambrick_encode_grad.clear_cache()
    ft, jt_ = ts.streambrick_encode_grad(TCFG, T(table), T(x), **kw)
    np.testing.assert_allclose(N(ft), N(fj), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(N(jt_), N(jj), rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(
        N(ts.streambrick_encode(TCFG, T(table), T(x), **kw)), N(fj),
        rtol=1e-5, atol=1e-5)
    if option == "per level, overflow":
        # the per-level plan overflows where the grouped path's aligned
        # caps would not: the two give other features here
        assert (N(ft) == 0).any()
        grouped = dict(kw, tile=256)
        fg = ts.streambrick_encode(TCFG, T(table), T(x), **grouped)
        caps = ts._tile_classes(TCFG, 192, 8, 1.5, 4, 0, 0.0, 0.7,
                                kw["caps_override"])[0][0]
        assert ts._grouped(TCFG, 192, [(caps, 8, 8)]) is False
        assert ts._grouped(TCFG, 256, [(caps, 8, 8)]) is True
        assert not np.array_equal(N(fg)[:1000], N(ft)[:1000])


def test_head_class_only_on_a_sorted_stream():
    """_stream_kwargs arms the head class for stream="sorted" alone, and
    the measured caps only for an encoder of their level count."""
    cfg = tngp.NGPConfig(encoder="brick", stream_dedup=True, rgb_L=16,
                         density_L=8, stream_head_frac=0.5,
                         stream_caps=tuple(range(16, 32)))
    on = tngp._stream_kwargs(cfg, cfg.rgb_brick_cfg, "sorted")
    off = tngp._stream_kwargs(cfg, cfg.rgb_brick_cfg, True)
    assert (on["seg_head"], on["head_frac"]) == (20, 0.5)
    assert (off["seg_head"], off["head_frac"]) == (0, 0.0)
    assert on["caps_override"] == tuple(range(16, 32))
    assert tngp._stream_kwargs(cfg, cfg.density_brick_cfg, "sorted"
                               )["caps_override"] is None
    for enc, want in (("brick", True), ("fused", True), ("hash", False)):
        c = tngp.NGPConfig(encoder=enc, stream_dedup=True)
        assert tngp._use_stream(c, "sorted") is want
        assert tngp._use_stream(c, False) is False
        j = jngp.NGPConfig(encoder=enc, stream_dedup=True)
        assert jngp._use_stream(j, "sorted") is want


def test_unsorted_train_step_matches():
    """stream_sort=False: no sort, no inverse permutation; one f32 step
    against JAX's."""
    check_step("brick, unsorted")


# ------------------------------------------------------- auto-calibration

def _stub(cls, cfg, step):
    """The state `_maybe_grow_stream_caps` reads, of the class cls."""
    return SimpleNamespace(
        model_cfg=cfg, global_step=step, AUTOCAL_MARGIN=cls.AUTOCAL_MARGIN,
        AUTOCAL_EVERY=cls.AUTOCAL_EVERY, _build_step=lambda: None,
        _test_render_cache={})


def test_autocal_caps_sequence_matches():
    """The same run counts through JAX's and the port's
    _maybe_grow_stream_caps: adopt, grow, keep, the formula floor, the
    tile cap, off-cadence and gated-off (-1) reads."""
    kw = dict(encoder="brick", stream_dedup=True, density_L=16, rgb_L=16)
    js_, ts_ = (_stub(jt.NeRFSystem, jngp.NGPConfig(**kw), 0),
                _stub(tt.NeRFSystem, tngp.NGPConfig(**kw), 0))
    rng = np.random.default_rng(0)
    seq = [(16, rng.integers(0, 200, 16)), (32, np.full(16, 3)),
           (40, np.full(16, 250)), (48, np.full(16, -1)),
           (48, rng.integers(0, 260, 16)), (64, np.full(16, 0)),
           (80, rng.integers(100, 300, 16))]
    trail = []
    for step, runs in seq:
        js_.global_step = ts_.global_step = step
        jt.NeRFSystem._maybe_grow_stream_caps(js_, runs.astype(np.int32))
        tt.NeRFSystem._maybe_grow_stream_caps(
            ts_, torch.as_tensor(runs.astype(np.int32)))
        assert ts_.model_cfg.stream_caps == js_.model_cfg.stream_caps
        trail.append(ts_.model_cfg.stream_caps)
    assert trail[0] is not None and trail[1] == trail[0]
    assert trail[2] == trail[1]          # step 40 is off the cadence
    assert trail[4] != trail[3] and max(trail[-1]) == 256


def _tiny(**kw):
    from tests.test_torch_faults import _hparams
    return _hparams(**{"stream_autocal": True, "march_iters": 1024,
                       "steps_per_epoch": 20, **kw})


def test_autocal_adopts_in_training_and_round_trips(tmp_path):
    """16 steps with stream_autocal: the run counts are measured on the
    16th alone, JAX's rule on them gives the adopted caps, the test
    render reads them; `last`, `last_slim` and the epoch checkpoints
    carry them and a load restores them."""
    tr = SyntheticDataset(split="train", img_size=8, n_train=2)
    te = SyntheticDataset(split="test", img_size=8, n_test=1)
    system = tt.NeRFSystem(_tiny(), tr, te, device="cpu")
    assert system.render_cfg.run_stats and not system.render_cfg_test.run_stats
    seen = []
    system.fit(log_every=0, rng=np.random.default_rng(0),
               use_native_loader=False, on_step=lambda s, aux: seen.append(
                   (s, aux.get("stream_runs"))), ckpt_dir=str(tmp_path))
    measured = [(s, r) for s, r in seen if r is not None]
    assert [s for s, _ in measured] == [15]
    ref = _stub(jt.NeRFSystem, jngp.NGPConfig(
        **{k: getattr(system.model_cfg, k) for k in (
            "encoder", "stream_dedup", "density_L", "rgb_L", "density_log2T",
            "rgb_log2T", "stream_tile", "stream_slack", "stream_seg")}), 16)
    jt.NeRFSystem._maybe_grow_stream_caps(ref, N(measured[0][1]))
    caps = system.model_cfg.stream_caps
    assert caps is not None and caps == ref.model_cfg.stream_caps
    seen_caps = []
    real = ts.streambrick_encode

    def spy(*a, **k):
        seen_caps.append(k.get("caps_override"))
        return real(*a, **k)
    ts.streambrick_encode = spy
    tngp.streambrick_encode = spy
    try:
        system.render_image(te.poses[0])
    finally:
        ts.streambrick_encode = real
        tngp.streambrick_encode = real
    assert seen_caps and set(seen_caps) == {caps}
    for name in ("last", "last_slim", "steps/20/state.pt"):
        state = tckpt.load_ckpt(str(tmp_path / name))
        assert tuple(int(c) for c in state["stream_caps"]) == caps, name
        fresh = tt.NeRFSystem(_tiny(), tr, device="cpu")
        assert fresh.model_cfg.stream_caps is None
        fresh.load_state(state)
        assert fresh.model_cfg.stream_caps == caps
    assert "stream_caps" not in tt.NeRFSystem(_tiny(), tr,
                                              device="cpu").state()


# ------------------------------------------------------------ the CLI

CLI = ["--dataset_name", "synthetic", "--num_epochs", "1",
       "--normal_epochs", "0", "--steps_per_epoch", "2", "--batch_size",
       "256", "--capacity", "16", "--march_iters", "64",
       "--samples_per_ray", "8", "--grid_size", "16", "--density_L", "2",
       "--rgb_L", "2", "--density_log2T", "10", "--rgb_log2T", "10",
       "--downsample", "0.125", "--encoder", "brick", "--stream_dedup",
       "--encode_chunk", "2048", "--no_save_test"]


@pytest.mark.parametrize("flags", [["--encoder", "fused"],
                                   ["--stream_head_frac", "0.5"],
                                   ["--no_stream_sort"],
                                   ["--stream_autocal"]],
                         ids=lambda f: f[0])
def test_train_main_runs_each_option(flags, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    m = train_cli.main(CLI + flags, device="cpu")
    assert np.isfinite(m["psnr"])
    assert (tmp_path / "ckpts" / "synthetic" / "exp" / "last").is_file()
