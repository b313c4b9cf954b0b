"""One rank of tests/test_torch_distributed.py's two-process run.

Usage: python _torch_dp_worker.py <rank> <nprocs> <init URL> <outdir>

Joins the gloo group through `parallel.init_distributed` (a file:// URL,
no TCP port), then, on the CPU with one torch thread:
1. --num_gpus semantics: 3 steps of NeRFSystem over the world on the
   global batches of tests/test_torch_distributed.py (each rank takes
   its half), then `validate` with each view's chunks split over the
   ranks;
2. --distributed semantics: 3 steps where each rank feeds its own half
   of the same global batches, then the round-robin `validate` over 3
   test views (uneven: rank 0 renders 2);
3. `fit` into a shared directory for 2 steps, then a fresh system's
   `fit` there, which resumes at the step rank 0 broadcasts;
4. the first batch of the sampler `fit` takes, on each rank;
5. `train.main` with --distributed on the group already joined.
Every rank writes its results under <outdir> as rank<r>_<name>.npy.
"""
import os
import sys

rank, nprocs, init_url, outdir = (int(sys.argv[1]), int(sys.argv[2]),
                                  sys.argv[3], sys.argv[4])
sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(1)

from ingp_tpu_torch import train as train_cli  # noqa: E402
from ingp_tpu_torch.data.synthetic import SyntheticDataset  # noqa: E402
from ingp_tpu_torch.parallel import (init_distributed,  # noqa: E402
                                     world_from_group)
from ingp_tpu_torch.training.trainer import NeRFSystem  # noqa: E402
from tests.test_torch_distributed import (BATCH, CLI, TABLE_SCALE,  # noqa
                                          hparams)


def save(name, value):
    np.save(os.path.join(outdir, f"rank{rank}_{name}.npy"),
            np.asarray(value))


assert init_distributed(init_url, nprocs, rank, device="cpu")
h = hparams()
tr = SyntheticDataset(split="train", img_size=32, n_train=4)
te = SyntheticDataset(split="test", img_size=32, n_test=3)
params = NeRFSystem(h, tr, device="cpu").params_to_numpy()
for k in ("density_table", "rgb_table"):
    params["model"][k] = params["model"][k] * np.float32(TABLE_SCALE)

for mode, own in (("gpus", False), ("distributed", True)):
    world = world_from_group("cpu", feeds_own_batch=own)
    system = NeRFSystem(h, tr, te, device="cpu", params=params, world=world)
    rng = np.random.default_rng(0)
    local = BATCH // nprocs
    for _ in range(3):
        g = tr.sample_batch(rng, BATCH)
        batch = {k: v[rank * local:(rank + 1) * local] for k, v in g.items()
                 } if own else g
        aux = system.training_step(batch)
    save(f"{mode}_loss", float(aux["loss"]))
    save(f"{mode}_table", system.params_to_numpy()["model"]["density_table"])
    m = system.validate()
    save(f"{mode}_val", [m["psnr"], m["ssim"]])

# epoch checkpoints by rank 0, the resume step broadcast from it
h2 = hparams(steps_per_epoch=2)
ckdir = os.path.join(outdir, "run")
first = NeRFSystem(h2, tr, te, device="cpu", world=world)
first.fit(log_every=0, ckpt_dir=ckdir)
again = NeRFSystem(h2, tr, te, device="cpu", world=world)
again.fit(log_every=0, ckpt_dir=ckdir)
save("resume_step", again.global_step)
save("resumed_table", again.params_to_numpy()["model"]["density_table"])

sampler = again.native_sampler()
save("native_pix", sampler.next_batch()["pix_idxs"])
sampler.close()

os.makedirs(os.path.join(outdir, "cli"), exist_ok=True)
os.chdir(os.path.join(outdir, "cli"))
m = train_cli.main(CLI + ["--distributed"], device="cpu")
save("cli_val", [m["psnr"], m["ssim"]])
print(f"rank {rank}: done", flush=True)
