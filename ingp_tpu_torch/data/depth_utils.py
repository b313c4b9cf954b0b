"""PFM depth-map reader (counterpart of ingp_tpu/data/depth_utils.py)."""
from __future__ import annotations

import re

import numpy as np


def read_pfm(path):
    """(data, scale) of a PFM file; data flipped to top-down row order."""
    with open(path, "rb") as f:
        header = f.readline().rstrip()
        if header == b"PF":
            color = True
        elif header == b"Pf":
            color = False
        else:
            raise ValueError("Not a PFM file: " + str(path))
        dims = f.readline()
        while dims.startswith(b"#"):  # comments
            dims = f.readline()
        m = re.match(rb"^(\d+)\s(\d+)\s$", dims)
        if not m:
            raise ValueError("Malformed PFM header")
        width, height = map(int, m.groups())
        scale = float(f.readline().rstrip())
        endian = "<" if scale < 0 else ">"
        data = np.fromfile(f, endian + "f")
        shape = (height, width, 3) if color else (height, width)
        return np.flipud(np.reshape(data, shape)), abs(scale)
