"""The port's command line on the CPU: `ingp_tpu_torch.train.main` on
configs/synthetic_smoke.txt (cut to 3 steps, 16 px and a tiny model by
flags that override the file) trains, writes its epoch checkpoint,
`last`, `last_slim` and metrics.jsonl under ckpts/<dataset>/<exp>, and
prints `test/psnr .. test/ssim ..`; `--ckpt_load last --val_only`
reproduces its metrics exactly. And the quality gate
(`ingp_tpu_torch.quality_synthetic`) at a tiny size and its bar."""
import os

import numpy as np
import pytest

from ingp_tpu_torch import quality_synthetic as gate
from ingp_tpu_torch import train as train_cli

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--steps_per_epoch", "3", "--downsample", "0.125",
         "--density_L", "2", "--rgb_L", "2", "--density_log2T", "10",
         "--rgb_log2T", "10", "--grid_size", "16", "--capacity", "16",
         "--samples_per_ray", "8", "--march_iters", "64", "--batch_size",
         "256"]


def test_train_main_writes_checkpoints_and_reloads(tmp_path, monkeypatch,
                                                   capsys):
    monkeypatch.chdir(tmp_path)
    argv = ["--config", os.path.join(ROOT, "configs", "synthetic_smoke.txt")
            ] + SMALL
    m = train_cli.main(argv, device="cpu")
    out = capsys.readouterr().out
    assert f"test/psnr {m['psnr']:.3f}  test/ssim {m['ssim']:.4f}" in out
    assert np.isfinite(m["psnr"]) and 0 < m["ssim"] <= 1
    run = tmp_path / "ckpts" / "synthetic" / "smoke"
    for name in ("last", "last_slim", "metrics.jsonl"):
        assert (run / name).is_file(), name
    assert os.listdir(run / "steps") == ["3"]
    again = train_cli.main(argv + ["--ckpt_load", str(run / "last"),
                                   "--val_only"], device="cpu")
    assert again == m
    # the slim checkpoint carries the same weights
    slim = train_cli.main(argv + ["--ckpt_load", str(run / "last_slim"),
                                  "--val_only"], device="cpu")
    assert np.isfinite(slim["psnr"])


def test_quality_gate_runs_small(capsys):
    m = gate.run(["--steps", "2", "--batch", "128", "--img_size", "16",
                  "--n_train", "2", "--chunk", "1024", "--spr", "8",
                  "--capacity", "16"], device="cpu", density_L=2, rgb_L=2,
                 density_log2T=10, rgb_log2T=10, grid_size=16,
                 compute_dtype="float32", table_dtype="float32",
                 march_iters=64)
    out = capsys.readouterr().out
    assert f"RESULT novel-view psnr {m['psnr']:.2f} ssim {m['ssim']:.4f}" \
        in out
    assert len(m["losses"]) == 2 and all(np.isfinite(m["losses"]))
    h = gate.gate_hparams(gate.build_parser().parse_args([]))
    assert (h.steps_per_epoch, h.batch_size, h.capacity, h.samples_per_ray,
            h.encode_chunk, h.sparsity_loss, h.stream_dedup,
            h.table_dtype) == (600, 8192, 48, 24, 98304, 1e-3, True,
                               "bfloat16")
    # two stream chunks per step: 8192 rays x 24 samples > 98304
    assert h.batch_size * h.samples_per_ray > h.encode_chunk


@pytest.mark.parametrize("psnr, ssim, ok", [(26.0, 0.865, True),
                                            (25.99, 0.9, False),
                                            (27.0, 0.864, False)])
def test_quality_gate_bar(psnr, ssim, ok):
    assert gate.passes({"psnr": psnr, "ssim": ssim}) is ok
