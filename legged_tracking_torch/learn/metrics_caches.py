"""Running-mean metric caches for curriculum telemetry.

Copy of the JAX package's ``learn/metrics_caches.py``, port of
``go1_gym_learn/ppo/metrics_caches.py`` (DistCache :6-33 /
SlotCache :46-88): host-side numpy accumulators drained into the logger each
iteration.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np


class DistCache:
    """Running means of arbitrary named arrays."""

    def __init__(self):
        self.cache = defaultdict(lambda: 0)

    def log(self, **key_vals):
        for k, v in key_vals.items():
            count = self.cache[k + "@counts"] + 1
            self.cache[k + "@counts"] = count
            self.cache[k] = (np.asarray(v) + (count - 1) * self.cache[k]) / count

    def get_summary(self):
        ret = {k: v for k, v in self.cache.items() if not k.endswith("@counts")}
        self.cache.clear()
        return ret


class SlotCache:
    """Per-slot (e.g. per-curriculum-bin) running means."""

    def __init__(self, n: int):
        self.n = n
        self.cache = defaultdict(lambda: np.zeros([n]))

    def log(self, slots=None, **key_vals):
        if slots is None:
            slots = range(self.n)
        for k, v in key_vals.items():
            counts = self.cache[k + "@counts"][slots] + 1
            self.cache[k + "@counts"][slots] = counts
            self.cache[k][slots] = (np.asarray(v) + (counts - 1) * self.cache[k][slots]) / counts

    def get_summary(self):
        ret = {k: v for k, v in self.cache.items() if not k.endswith("@counts")}
        self.cache.clear()
        return ret
