"""Grid-bin command curricula (port of ``tasks/curriculum.py``).

:class:`HostCurriculum` and :class:`HostRewardThresholdCurriculum` are numpy
copies of the JAX package's host ports of the reference ``Curriculum`` and
``RewardThresholdCurriculum``, for host tooling and tests.

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


class HostCurriculum:
    """Numpy parity port of the reference ``Curriculum`` (go1_gym/envs/base/
    curriculum.py:17-89), for host tooling and tests; a copy of the JAX
    package's, bitwise with it on one seed (``np.random.RandomState``)."""

    def __init__(self, seed, **key_ranges):
        self.rng = np.random.RandomState(seed)
        self.keys = list(key_ranges.keys())
        self.grid, self.bin_sizes = _make_grid(list(key_ranges.values()))
        self.lows = np.array([r[0] for r in key_ranges.values()])
        self.highs = np.array([r[1] for r in key_ranges.values()])
        self.weights = np.zeros(self.grid.shape[0])
        self.indices = np.arange(self.grid.shape[0])

    def __len__(self):
        return self.grid.shape[0]

    def set_to(self, low, high, value=1.0):
        inds = np.logical_and(self.grid >= low[None, :],
                              self.grid <= high[None, :]).all(axis=1)
        assert inds.any(), "empty initialization domain"
        self.weights[inds] = value

    def sample_bins(self, batch_size, low=None, high=None):
        w = self.weights
        if low is not None and high is not None:
            valid = np.logical_and(self.grid >= low[None, :],
                                   self.grid <= high[None, :]).all(axis=1)
            w = np.where(valid, w, 0.0)
        inds = self.rng.choice(self.indices, batch_size, p=w / w.sum())
        return self.grid[inds], inds

    def sample(self, batch_size, low=None, high=None):
        centroids, inds = self.sample_bins(batch_size, low=low, high=high)
        samples = np.stack([
            self.rng.uniform(c + self.bin_sizes / 2, c - self.bin_sizes / 2)
            for c in centroids])
        return samples, inds


class HostRewardThresholdCurriculum(HostCurriculum):
    """Numpy parity port of the reference ``RewardThresholdCurriculum``
    (:113-159): each success bumps its bin and the bins within
    ``local_range`` by 0.2, one success after another, clipped to [0, 1]."""

    def get_local_bins(self, bin_inds, ranges=0.1):
        if isinstance(ranges, float):
            ranges = np.ones(self.grid.shape[1]) * ranges
        bin_inds = np.asarray(bin_inds).reshape(-1)
        near = np.logical_and(
            self.grid[None, :, :] >= self.grid[bin_inds][:, None, :] - ranges[None, None, :],
            self.grid[None, :, :] <= self.grid[bin_inds][:, None, :] + ranges[None, None, :],
        ).all(axis=2)
        return near  # (len(bin_inds), n_bins)

    def update(self, bin_inds, task_rewards, success_thresholds, local_range=0.5):
        if len(success_thresholds) == 0:
            return
        is_success = np.ones(len(bin_inds), dtype=bool)
        for r, t in zip(task_rewards, success_thresholds):
            is_success &= np.asarray(r) > t
        self.weights[bin_inds[is_success]] = np.clip(
            self.weights[bin_inds[is_success]] + 0.2, 0, 1)
        for near in self.get_local_bins(bin_inds[is_success], ranges=local_range):
            self.weights[near] = np.clip(self.weights[near] + 0.2, 0, 1)


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
