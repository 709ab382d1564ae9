"""Learner utilities: running obs normalization (port of ``learn/utils.py``).

``RunningMeanStd`` is the reference's streaming mean/var
(``go1_gym_learn/utils/running_average.py``, Chan's parallel variance) as an
immutable tuple of tensors: ``update`` returns a new one.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class RunningMeanStd(NamedTuple):
    mean: torch.Tensor
    var: torch.Tensor
    count: torch.Tensor     # () float32

    @staticmethod
    def create(shape, epsilon: float = 1e-2, device="cuda") -> "RunningMeanStd":
        return RunningMeanStd(mean=torch.zeros(shape, device=device),
                              var=torch.ones(shape, device=device),
                              count=torch.tensor(epsilon, dtype=torch.float32, device=device))

    def update(self, arr, all_reduce_sum=None) -> "RunningMeanStd":
        """Take in a batch (rows of ``arr``).  ``all_reduce_sum``: where the
        rows are one rank's shard of a data-parallel batch, the collective
        that sums the batch's count, sum and sum of squares (float64) over
        the ranks, so that the statistics take in the global batch."""
        arr = arr.to(self.mean.dtype)       # float32 stats even for bf16 streams
        if all_reduce_sum is None:
            batch_mean = torch.mean(arr, dim=0)
            batch_var = torch.var(arr, dim=0, correction=0)     # jnp.var is ddof 0
            batch_count = arr.shape[0]
        else:
            a = arr.double()
            n, s, ss = all_reduce_sum([torch.full((), arr.shape[0], dtype=torch.float64,
                                                  device=arr.device),
                                       a.sum(dim=0), a.square().sum(dim=0)])
            m = s / n
            batch_mean = m.to(arr.dtype)
            batch_var = torch.clamp(ss / n - m * m, min=0.0).to(arr.dtype)
            batch_count = n.to(arr.dtype)
        delta = batch_mean - self.mean
        tot = self.count + batch_count
        new_mean = self.mean + delta * batch_count / tot
        m2 = (self.var * self.count + batch_var * batch_count
              + torch.square(delta) * self.count * batch_count / tot)
        return RunningMeanStd(mean=new_mean, var=m2 / tot, count=tot)

    def normalize(self, obs):
        return (obs - self.mean) / torch.sqrt(self.var + 1e-8)
