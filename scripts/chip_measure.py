#!/usr/bin/env python3
"""Single measurements on the card, built from chip_smoke.py's phases:

    python3 scripts/chip_measure.py new            # device, build, native,
        # a bench-width system's 32-step fit under profile_dir, parallel
    python3 scripts/chip_measure.py profile-cost   # 3 windows of 30 bench
        # steps before and after a profiled fit, in one process
    python3 scripts/chip_measure.py lego-steps 500 600  # configs/lego.txt on
        # chip_smoke's NSVF fixture, one fit of each step count's own
        # schedule: its test PSNR, and the constant image's
    python3 scripts/chip_measure.py kitti          # phase "kitti" alone

Run from the repository root on a machine with an NVIDIA GPU.
"""
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke as cs  # noqa: E402


def _bench_system(steps):
    import numpy as np
    from ingp_tpu_torch.data.synthetic import SyntheticDataset
    from ingp_tpu_torch.training.trainer import NeRFSystem
    tr = SyntheticDataset(split="train", img_size=cs.IMG_SIZE,
                          n_train=cs.N_VIEWS)
    system = NeRFSystem(cs.bench_hparams(), tr, seed=0)
    rng = np.random.default_rng(0)
    for _ in range(steps):
        system.training_step(tr.sample_batch(rng, cs.BATCH))
    return system, tr, rng


def new():
    cs.phase_native()
    system, _, _ = _bench_system(3)
    cs.profile_fit(system)
    del system
    cs.phase_parallel()


def _window(system, tr, rng, n=30):
    import torch
    batches = [cs.stage(tr.sample_batch(rng, cs.BATCH), system.device)
               for _ in range(n)]
    torch.cuda.synchronize()
    t = time.perf_counter()
    for b in batches:
        system.training_step(b)
    torch.cuda.synchronize()
    return (time.perf_counter() - t) / n * 1e3


def profile_cost():
    system, tr, rng = _bench_system(19)
    cs.log(f"cost: ms a step before the profile "
           f"{[_window(system, tr, rng) for _ in range(3)]}")
    cs.profile_fit(system)
    cs.log(f"cost: ms a step after the profile "
           f"{[_window(system, tr, rng) for _ in range(3)]}")


def lego_steps(*counts):
    from ingp_tpu_torch import train as train_cli
    from ingp_tpu_torch.data.nsvf import NSVFDataset
    from ingp_tpu_torch.utils.blender_fixture import write_nsvf_scene
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            root = os.path.join(tmp, "Synthetic_NeRF", "Lego")
            write_nsvf_scene(root, 800, *cs.DATA_VIEWS)
            for steps in map(int, counts):
                t = time.time()
                m = train_cli.main([
                    "--config", os.path.join(ROOT, cs.LEGO_CONFIG),
                    "--root_dir", root, "--num_epochs", "1",
                    "--steps_per_epoch", str(steps), "--no_save_test",
                    "--exp_name", f"l{steps}"])
                cs.log(f"lego {steps} steps: test psnr {m['psnr']:.4f} "
                       f"({time.time() - t:.1f} s)")
            te = NSVFDataset(root_dir=root, split="test")
            cs.log(f"lego: the constant image {cs.const_psnr(te):.4f}")
        finally:
            os.chdir(cwd)


COMMANDS = {"new": new, "profile-cost": profile_cost,
            "lego-steps": lego_steps, "kitti": cs.phase_kitti}


def main(argv):
    import torch
    if not argv or argv[0] not in COMMANDS:
        print(__doc__, file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    cs.phase_device()
    cs.phase_build()
    COMMANDS[argv[0]](*argv[1:])
    cs.log(f"done in {time.time() - cs.T0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
