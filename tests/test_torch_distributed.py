"""The port's data parallelism across two real processes: gloo ranks on
the CPU, each its own Python process (tests/_torch_dp_worker.py), joined
through `parallel.init_distributed` over a file:// URL.

Against one process on the same global batches, on a non-binding sample
budget (capacity = samples_per_ray = 16: each shard keeps exactly the
samples the single process keeps): the port's own single process at the
bounds of tests/test_multiprocess.py (the loss to 1e-4, the density
table to rtol 1e-3 and atol 1e-6, the validation PSNR to 1e-3), and
JAX's single process at the same loss and PSNR bounds with the table to
1e-3 of its largest |value|, the port's bound for parameters after
training steps (tests/test_torch_train.py): against JAX the port's
single process itself misses rtol 1e-3 / atol 1e-6 on 1 of the table's
32,768 entries after these 3 steps (-3.928e-4 against -3.909e-4, a
near-zero Adam denominator amplifying a last-bit gradient difference),
whatever the ranks do. For both modes:
- --num_gpus semantics: one global batch of 256 rays split over the two
  ranks; --distributed semantics: each rank feeds its own 128 rays (the
  global batch is 2 x 128), its slice of the noise drawn over all 256;
- `validate`: each view's chunks split over the ranks (--num_gpus), and
  the views dealt round-robin over the ranks with 3 views (rank 0
  renders two, rank 1 one), the metrics gathered (--distributed);
- after 3 steps the two ranks hold the same parameters, bit for bit;
- a fresh system's `fit` on a directory with epoch checkpoints resumes
  on both ranks at the step rank 0 broadcasts;
- the native sampler that `fit` takes gives both ranks the same rays:
  JAX seeds every process's native sampler with hparams.seed
  (ingp_tpu/training/trainer.py:731-733), a fault of the reference that
  the port keeps (ROADMAP.md Queue 3);
- `train.main` with --distributed runs, and both ranks return the same
  metrics.
The parameters start from JAX's initial ones with the hash tables
scaled by TABLE_SCALE (tests/test_torch_native.py says why).
"""
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np

from tests._torch_threads import one_torch_thread  # noqa: F401

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
BATCH = 256
TABLE_SCALE = 1e3
CLI = ["--dataset_name", "synthetic", "--num_epochs", "1",
       "--normal_epochs", "0", "--steps_per_epoch", "2", "--batch_size",
       "128", "--capacity", "8", "--march_iters", "64",
       "--samples_per_ray", "8", "--grid_size", "16", "--density_L", "2",
       "--rgb_L", "2", "--density_log2T", "10", "--rgb_log2T", "10",
       "--downsample", "0.125", "--no_save_test"]


def hparams(**kw):
    """tests/test_multiprocess.py's configuration."""
    h = dict(dataset_name="synthetic", root_dir="", split="train",
             downsample=1.0, scale=0.5, use_skybox=False, use_exposure=False,
             embed_a=False, embed_a_len=4, embed_msk=False, num_classes=4,
             batch_size=BATCH, ray_sampling_strategy="all_images",
             num_epochs=1, normal_epochs=0, steps_per_epoch=500, lr=1e-2,
             density_threshold=1e-2, depth_mono=False, normal_mono=False,
             normal_ref=False, optimize_ext=False, random_bg=False,
             render_semantic=False, chunk_size=2048, seed=0,
             ckpt_load=None, compute_dtype="float32", capacity=16,
             march_iters=128, samples_per_ray=16, grid_size=32,
             density_L=4, density_F=2, density_log2T=12, rgb_L=4,
             rgb_F=2, rgb_log2T=12, logger="none", exp_name="t")
    h.update(kw)
    return SimpleNamespace(**h)


def _jax_reference():
    """3 JAX steps on the global batches in one process, then validate
    (JAX is imported here: the ranks import this module's constants)."""
    import jax
    import jax.numpy as jnp
    from ingp_tpu.data.synthetic import SyntheticDataset
    from ingp_tpu.training.trainer import NeRFSystem
    tr = SyntheticDataset(split="train", img_size=32, n_train=4)
    te = SyntheticDataset(split="test", img_size=32, n_test=3)
    system = NeRFSystem(hparams(), tr, te)
    params = jax.tree.map(lambda a: np.array(a, np.float32), system.params)
    for k in ("density_table", "rgb_table"):
        params["model"][k] *= np.float32(TABLE_SCALE)
    system.params = jax.tree.map(jnp.asarray, params)
    system.opt_state = system.tx.init(system.params)
    rng = np.random.default_rng(0)
    for _ in range(3):
        aux = system.training_step(tr.sample_batch(rng, BATCH))
    return (float(aux["loss"]),
            np.asarray(system.params["model"]["density_table"]),
            system.validate()["psnr"])


def _port_reference():
    """The port's single process on the same batches, parameters and
    validation."""
    from ingp_tpu_torch.data.synthetic import SyntheticDataset
    from ingp_tpu_torch.training.trainer import NeRFSystem
    h = hparams()
    tr = SyntheticDataset(split="train", img_size=32, n_train=4)
    te = SyntheticDataset(split="test", img_size=32, n_test=3)
    params = NeRFSystem(h, tr, device="cpu").params_to_numpy()
    for k in ("density_table", "rgb_table"):
        params["model"][k] = params["model"][k] * np.float32(TABLE_SCALE)
    system = NeRFSystem(h, tr, te, device="cpu", params=params)
    rng = np.random.default_rng(0)
    for _ in range(3):
        aux = system.training_step(tr.sample_batch(rng, BATCH))
    return (float(aux["loss"]),
            system.params_to_numpy()["model"]["density_table"],
            system.validate()["psnr"])


def test_two_processes_match_single(tmp_path):
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    url = f"file://{tmp_path / 'store'}"
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "_torch_dp_worker.py"),
         str(r), "2", url, str(tmp_path)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for r in (0, 1)]
    try:
        refs = {"jax": _jax_reference(), "port": _port_reference()}
        outs = [p.communicate(timeout=300)[0].decode() for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"rank failed:\n{out[-4000:]}"

    def got(rank, name):
        return np.load(tmp_path / f"rank{rank}_{name}.npy")

    for mode in ("gpus", "distributed"):
        table = got(0, f"{mode}_table")
        np.testing.assert_array_equal(got(1, f"{mode}_table"), table)
        for which, (loss_ref, table_ref, psnr_ref) in refs.items():
            loss = float(got(0, f"{mode}_loss"))
            assert abs(loss - loss_ref) < 1e-4 * max(1.0, abs(loss_ref)), \
                (mode, which)
            if which == "port":
                np.testing.assert_allclose(table, table_ref, rtol=1e-3,
                                           atol=1e-6, err_msg=mode)
            else:
                err = np.abs(table - table_ref).max()
                assert err <= 1e-3 * np.abs(table_ref).max(), (mode, err)
            for r in (0, 1):
                psnr = float(got(r, f"{mode}_val")[0])
                assert abs(psnr - psnr_ref) < 1e-3, (mode, which, r)
    for r in (0, 1):
        assert int(got(r, "resume_step")) == 2
    np.testing.assert_array_equal(got(0, "resumed_table"),
                                  got(1, "resumed_table"))
    # the reference's fault: both ranks draw the same rays
    np.testing.assert_array_equal(got(0, "native_pix"), got(1, "native_pix"))
    np.testing.assert_array_equal(got(0, "cli_val"), got(1, "cli_val"))
    assert np.isfinite(got(0, "cli_val")).all()
    assert "test/psnr" in outs[0] and "test/psnr" not in outs[1]
    assert (tmp_path / "cli" / "ckpts" / "synthetic" / "exp" /
            "last").is_file()
