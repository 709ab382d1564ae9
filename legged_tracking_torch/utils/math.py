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
    ``a * b + c`` is (XLA contracts it into a fused multiply-add).  Each
    argument is a tensor or a number.

    The product of two float32 values is exact in float64; the float64 sum
    ``s`` is not.  Rounding ``s`` to float32 gives the correctly rounded
    result unless ``s`` lies exactly on a float32 midpoint while the exact
    sum does not: then the tie goes to even where the exact sum would have
    gone to one side.  The exact error ``e`` of the addition (TwoSum) says
    which side; stepping ``s`` one float64 ulp toward it breaks the tie the
    same way."""
    f64 = lambda x: x.double() if torch.is_tensor(x) else float(x)
    p, c = f64(a) * f64(b), f64(c)
    s = p + c
    bp = s - p
    e = (p - (s - bp)) + (c - bp)                    # s + e == p + c exactly
    r = s.float()
    inf = float("inf")
    other = torch.nextafter(r, torch.where(s > r.double(), inf, -inf).float())
    tie = (r.double() + other.double()) * 0.5 == s   # exact: adjacent float32 values
    toward = torch.nextafter(s, torch.where(e > 0, inf, -inf).double())
    return torch.where(tie & (e != 0), toward, s).float()
