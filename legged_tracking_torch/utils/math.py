"""Misc batched math helpers (reference go1_gym/utils/math_utils.py semantics)."""

from __future__ import annotations


def get_scale_shift(rng):
    """Normalization scale/shift from a [lo, hi] range (math_utils.py:35-38)."""
    scale = 2.0 / (rng[1] - rng[0])
    shift = (rng[1] + rng[0]) / 2.0
    return scale, shift
