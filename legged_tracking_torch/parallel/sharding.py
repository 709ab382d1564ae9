"""Env-batch data parallelism: which envs a rank owns (counterpart of
``parallel/sharding.py``).

The JAX package splits the env axis of a global array over a ``data`` mesh
axis and replicates the parameters; XLA then makes every ``mean`` and
``sum`` global.  Here the W ranks are W processes: rank r of W owns the
global envs ``[r * n, (r + 1) * n)``, n = N / W, and every rank holds the
same parameters and optimizer state.  Code that reduces over the env axis
all-reduces its local sums (:mod:`.distributed`), so a W-rank run is the
1-rank run of the same N envs up to the order of float32 sums.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

from .distributed import flat, unflat


@dataclass(frozen=True)
class Shard:
    """Rank ``rank`` of ``world``, owning ``num_envs_global / world``
    consecutive envs."""
    rank: int
    world: int
    num_envs_global: int

    def __post_init__(self):
        if not 0 <= self.rank < self.world:
            raise ValueError(f"rank {self.rank} is not one of {self.world} ranks")
        if self.num_envs_global % self.world:
            # the JAX mesh refuses an env axis it cannot split evenly alike
            raise ValueError(f"{self.num_envs_global} envs do not divide over "
                             f"{self.world} ranks")

    @property
    def num_envs(self) -> int:
        """The envs this rank owns."""
        return self.num_envs_global // self.world

    @property
    def start(self) -> int:
        """The global id of this rank's first env."""
        return self.rank * self.num_envs

    @property
    def stop(self) -> int:
        return self.start + self.num_envs

    def global_ids(self, device=None) -> torch.Tensor:
        """(n,) int64 global ids of this rank's envs."""
        return torch.arange(self.start, self.stop, device=device)

    def shard_rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of ``x``, whose leading axis is the global env
        axis."""
        if x.shape[0] != self.num_envs_global:
            raise ValueError(f"leading axis {x.shape[0]} is not the "
                             f"{self.num_envs_global} global envs")
        return x[self.start:self.stop]

    def local_slice(self, lo: int, hi: int | None = None) -> slice:
        """The local rows of the global envs ``[lo, hi)`` (``hi`` None: to the
        end)."""
        hi = self.num_envs_global if hi is None else hi
        clip = lambda i: min(max(i - self.start, 0), self.num_envs)
        return slice(clip(lo), clip(hi))


def replicate(tensors: dict, src: int = 0) -> dict:
    """Broadcast rank ``src``'s values of a dict of tensors to every rank,
    in place, as one ``broadcast`` of one flat buffer (the JAX package's
    ``replicate``: a value every device holds alike).  Returns
    ``tensors``."""
    values = list(tensors.values())
    buf = flat(values)
    dist.broadcast(buf, src=src)
    with torch.no_grad():
        for t, v in zip(values, unflat(buf, values)):
            t.copy_(v)
    return tensors


def check_replicated(tensors: dict):
    """Raise unless every rank holds rank 0's values of ``tensors``, bitwise
    (:func:`replicate` of a copy, then a compare on each rank)."""
    ref = replicate({k: t.detach().clone() for k, t in tensors.items()})
    differ = [k for k, t in tensors.items() if not torch.equal(t.detach(), ref[k])]
    if differ:
        raise RuntimeError(f"rank {dist.get_rank()} holds other values than rank 0 "
                           f"for {differ}")
