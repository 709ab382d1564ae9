"""Misc batched math helpers (reference go1_gym/utils/math_utils.py semantics)."""

from __future__ import annotations

import torch


def get_scale_shift(rng):
    """Normalization scale/shift from a [lo, hi] range (math_utils.py:35-38)."""
    scale = 2.0 / (rng[1] - rng[0])
    shift = (rng[1] + rng[0]) / 2.0
    return scale, shift


def norm(x):
    """``jnp.linalg.norm`` over the last axis as XLA computes it: the root
    of the sum of squares."""
    return torch.sqrt(torch.sum(x * x, dim=-1))


def fma(a, b, c):
    """``a * b + c`` in float32, rounded once, as the JAX package's compiled
    ``a * b + c`` is (XLA contracts it into a fused multiply-add).  The
    product of two float32 values is exact in float64; the sum is rounded
    to float64 and then to float32.  Each argument is a tensor or a number."""
    f64 = lambda x: x.double() if torch.is_tensor(x) else float(x)
    return (f64(a) * f64(b) + f64(c)).float()
