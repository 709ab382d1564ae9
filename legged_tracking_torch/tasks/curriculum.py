"""Grid-bin command curriculum on the device (port of ``tasks/curriculum.py``).

:class:`DeviceCurriculum` is the JAX package's on-device form of the
reference's ``RewardThresholdCurriculum`` (go1_gym/envs/base/curriculum.py:
113-159): the weights live in the env state as a ``(num_categories,
num_bins)`` tensor; sampling draws one bin per env with probability
proportional to its weight and a uniform value inside the bin; the
success-driven bump (the bin and its neighbours within ``local_range``, +0.2,
clipped to [0, 1]) is a masked one-hot product.  Simultaneous successes add
up before the clip, as in the JAX package.

Every table (the bin centres, the bin sizes, the neighbourhoods) is built
once, in numpy float32 as the JAX package builds it, and lives on the
device; neither ``sample`` nor ``update`` waits for the host.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.math import fma


def _make_grid(key_ranges):
    """Bin-centre grid (n_bins, d) + bin sizes (d,) (reference :28-55)."""
    centres = []
    sizes = []
    for lo, hi, n in key_ranges:
        size = (hi - lo) / n
        centres.append(np.linspace(lo + size / 2, hi - size / 2, n))
        sizes.append(size)
    mesh = np.meshgrid(*centres, indexing="ij")
    grid = np.stack([m.ravel() for m in mesh], axis=1)  # (n_bins, d)
    return grid.astype(np.float32), np.asarray(sizes, dtype=np.float32)


def neighbour_table(grid, local_range) -> np.ndarray:
    """(n_bins, n_bins) bool: bin j lies within ``local_range`` of bin i
    along every dimension (float32, as the JAX package compares)."""
    lr = np.asarray(local_range, dtype=np.float32)
    return np.logical_and(
        grid[None, :, :] >= grid[:, None, :] - lr[None, None, :],
        grid[None, :, :] <= grid[:, None, :] + lr[None, None, :],
    ).all(axis=2)


class DeviceCurriculum:
    """On-device RewardThresholdCurriculum over category-wise weights."""

    def __init__(self, key_ranges, init_low, init_high, local_range,
                 num_categories: int, device="cuda"):
        grid, sizes = _make_grid(key_ranges)
        near = neighbour_table(grid, local_range)
        t = lambda a: torch.as_tensor(a, device=device)
        self.grid = t(grid)
        self.bin_sizes = t(sizes)
        self.neighbour = t(near)
        # the bins a success in bin i bumps: its neighbourhood and itself
        self.hits = t((near | np.eye(grid.shape[0], dtype=bool)).astype(np.float32))
        init = np.logical_and(grid >= np.asarray(init_low)[None, :],
                              grid <= np.asarray(init_high)[None, :]).all(axis=1)
        assert init.any(), "empty initialization domain"
        self.init_weights = t(np.tile(init.astype(np.float32), (num_categories, 1)))
        self.num_bins = grid.shape[0]
        self.num_categories = num_categories

    def bins_from_uniform(self, weights, categories, u):
        """Per-env bin of category ``categories`` (N,) drawn with probability
        proportional to ``max(w, 1e-12)`` over its row of ``weights`` (C,
        n_bins), by the inverse CDF of one uniform ``u`` (N,) in [0, 1).

        The JAX package draws the same distribution as the argmax of logits
        ``log(max(w, 1e-12))`` plus Gumbel noise.  A bin of weight 0 keeps
        its 1e-12 share of the CDF; as with the JAX package's float32 noise,
        a float32 uniform never reaches it.  The CDF is summed in float64,
        so the card and the CPU cut it at the same points to 1e-16."""
        p = torch.clamp(weights[categories.long()].double(), min=1e-12)   # (N, n_bins)
        cdf = torch.cumsum(p, dim=1)
        v = u.double() * cdf[:, -1]
        bins = torch.searchsorted(cdf, v[:, None], right=True)[:, 0]
        return torch.clamp(bins, max=self.num_bins - 1).to(torch.int32)

    def values(self, bins, u):
        """The commands of ``bins`` (N,): the bin centre plus ``u`` (N, d) in
        [-0.5, 0.5) bin sizes, one rounding (the JAX package's compiled
        ``c + u * bin_sizes`` is a fused multiply-add)."""
        return fma(u, self.bin_sizes, self.grid[bins.long()])

    def update(self, weights, categories, bins, success, reduce=None):
        """Masked bump of the successful envs' bins and their neighbourhoods:
        ``einsum("nc,nb->cb")`` of the category one-hots and the hit rows.
        The counts are small integers in float32, exact in any order.
        ``reduce``: where the envs are a shard of a data-parallel run, the
        all-reduce that adds the (C, n_bins) bump over the ranks."""
        contrib = self.hits[bins.long()] * success[:, None].to(weights.dtype)   # (N, n_bins)
        cat_oh = torch.nn.functional.one_hot(categories.long(), self.num_categories)
        bump = torch.einsum("nc,nb->cb", cat_oh.to(weights.dtype), contrib)
        if reduce is not None:
            bump = reduce(bump)
        # reference stacking semantics (curriculum.py:148-154): overlapping
        # neighbourhoods accumulate before the clip; XLA fuses the + 0.2 *
        return torch.clamp(fma(np.float32(0.2), bump, weights), 0.0, 1.0)
