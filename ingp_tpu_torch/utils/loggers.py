"""Experiment loggers (counterpart of ingp_tpu/utils/loggers.py).

  JsonlLogger        append-only metrics.jsonl (the hermetic default)
  TensorBoardLogger  torch.utils.tensorboard's SummaryWriter
  WandbLogger        wandb, where installed

Select with --logger {jsonl,tb,wandb,none} (training/config.py). The tb
and wandb backends import their packages when built and raise when
those are absent.
"""
from __future__ import annotations

import json
import os


class ExperimentLogger:
    def log_metrics(self, step: int, metrics: dict) -> None:
        raise NotImplementedError

    def log_image(self, step: int, tag: str, image) -> None:
        pass  # optional

    def close(self) -> None:
        pass


class JsonlLogger(ExperimentLogger):
    """One JSON object per line; images go to PNG files in val/ beside
    it."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "a")
        self._img_dir = os.path.join(os.path.dirname(path) or ".", "val")

    def log_metrics(self, step, metrics):
        self._f.write(json.dumps({"step": step, **metrics}) + "\n")
        self._f.flush()

    def log_image(self, step, tag, image):
        from .vis import save_image
        os.makedirs(self._img_dir, exist_ok=True)
        save_image(image, os.path.join(self._img_dir,
                                       f"{step:05d}_{tag}.png"))

    def close(self):
        self._f.close()


class TensorBoardLogger(ExperimentLogger):
    def __init__(self, logdir: str):
        from torch.utils.tensorboard import SummaryWriter
        self._w = SummaryWriter(logdir)

    def log_metrics(self, step, metrics):
        for k, v in metrics.items():
            try:
                self._w.add_scalar(k, float(v), step)
            except (TypeError, ValueError):
                pass

    def log_image(self, step, tag, image):
        self._w.add_image(tag, image, step, dataformats="HWC")

    def close(self):
        self._w.close()


class WandbLogger(ExperimentLogger):
    """Weights & Biases backend; raises when wandb is not installed."""

    def __init__(self, project: str, name: str | None = None, **kwargs):
        try:
            import wandb
        except ImportError as e:
            raise RuntimeError(
                "--logger wandb needs the wandb package") from e
        self._wandb = wandb
        self._run = wandb.init(project=project, name=name, **kwargs)

    def log_metrics(self, step, metrics):
        self._wandb.log(metrics, step=step)

    def log_image(self, step, tag, image):
        self._wandb.log({tag: self._wandb.Image(image)}, step=step)

    def close(self):
        self._run.finish()


def make_logger(kind: str, ckpt_dir: str, exp_name: str = "exp"):
    """The logger of a run. kind: jsonl | tb | wandb | none."""
    if kind == "none":
        return None
    if kind == "jsonl":
        return JsonlLogger(os.path.join(ckpt_dir, "metrics.jsonl"))
    if kind == "tb":
        return TensorBoardLogger(os.path.join(ckpt_dir, "tb"))
    if kind == "wandb":
        return WandbLogger(project="ingp_tpu", name=exp_name)
    raise ValueError(f"unknown logger {kind!r}")
