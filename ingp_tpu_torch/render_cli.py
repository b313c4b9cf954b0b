"""Offline render entry point of the port: `python -m
ingp_tpu_torch.render_cli --config cfg.txt ...` (counterpart of
ingp_tpu/render_cli.py): builds the system from the flags on the card
(or on `device`), loads ckpts/<dataset_name>/<exp_name>/last (else
last_slim) and renders the test split into
results/<dataset_name>/<exp_name> (`render.offline.render_for_test`).
"""
from __future__ import annotations

from .render.offline import render_for_test
from .training.config import get_opts


def main(argv=None, device=None):
    """Render as the flags say; returns the output directory."""
    hparams = get_opts(argv)
    out = render_for_test(hparams, device=device)
    print(f"wrote renders to {out}", flush=True)
    return out


if __name__ == "__main__":
    main()
