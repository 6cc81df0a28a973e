"""Minimal ds9 region parser → boolean pixel mask.

Replaces the reference's ``pyregion`` dependency (musefuse.py:51-56) for the
common shapes: circle, box, ellipse, polygon (image coordinates, 1-based as
per ds9 convention). Uses ``pyregion`` when installed.

The port's own copy of ``massivedatans_tpu/muse/regions.py``:
same names and masks.
"""

from __future__ import annotations

import re

import numpy as np


def _shape_mask(shape: str, args, ny: int, nx: int) -> np.ndarray:
    yy, xx = np.mgrid[0:ny, 0:nx]
    # ds9 image coords are 1-based with (x, y) order
    if shape == "circle":
        x0, y0, r = args
        return (xx - (x0 - 1)) ** 2 + (yy - (y0 - 1)) ** 2 <= r ** 2
    if shape == "box":
        x0, y0, w, h = args[:4]
        angle = args[4] if len(args) > 4 else 0.0
        dx, dy = xx - (x0 - 1), yy - (y0 - 1)
        if angle:
            c, s = np.cos(np.radians(angle)), np.sin(np.radians(angle))
            dx, dy = c * dx + s * dy, -s * dx + c * dy
        return (np.abs(dx) <= w / 2) & (np.abs(dy) <= h / 2)
    if shape == "ellipse":
        x0, y0, a, b = args[:4]
        angle = args[4] if len(args) > 4 else 0.0
        dx, dy = xx - (x0 - 1), yy - (y0 - 1)
        if angle:
            c, s = np.cos(np.radians(angle)), np.sin(np.radians(angle))
            dx, dy = c * dx + s * dy, -s * dx + c * dy
        return (dx / a) ** 2 + (dy / b) ** 2 <= 1.0
    if shape == "polygon":
        px = np.asarray(args[0::2]) - 1
        py = np.asarray(args[1::2]) - 1
        # even-odd rule
        inside = np.zeros((ny, nx), bool)
        n = len(px)
        for i in range(n):
            j = (i - 1) % n
            cond = ((py[i] > yy) != (py[j] > yy)) & (
                xx < (px[j] - px[i]) * (yy - py[i])
                / (py[j] - py[i] + 1e-30) + px[i]
            )
            inside ^= cond
        return inside
    raise ValueError(f"unsupported region shape {shape!r}")


def parse_region_mask(text: str, shape_yx: tuple[int, int]) -> np.ndarray:
    """Boolean mask (ny, nx) of pixels inside any region in the ds9 text."""
    try:
        import pyregion

        return pyregion.parse(text).get_mask(shape=shape_yx)
    except ImportError:
        pass

    ny, nx = shape_yx
    mask = np.zeros((ny, nx), bool)
    pattern = re.compile(r"(-?)(circle|box|ellipse|polygon)\(([^)]*)\)", re.I)
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        for m in pattern.finditer(line):
            neg, shape, argstr = m.group(1), m.group(2).lower(), m.group(3)
            args = [float(a.strip().rstrip('"')) for a in argstr.split(",")]
            sm = _shape_mask(shape, args, ny, nx)
            if neg:
                mask &= ~sm
            else:
                mask |= sm
    return mask
