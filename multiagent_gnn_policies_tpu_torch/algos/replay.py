"""Structure-of-arrays replay buffer on the device.

The counterpart of the JAX package's ``algos/replay.py``: a preallocated
tensor per record field with leading dim ``capacity``, filled as a ring.
``size`` and ``cursor`` are Python ints, so the trainers' update gate
``size > batch_size`` never waits on the device; ``size`` also has a
device copy, set with it, which the sample reads, so that a sample
captured into a CUDA graph masks with the size of each replay, not the
size at capture.

Sampling is uniform without replacement over the filled prefix: a uniform
per slot, slots past ``size`` masked to ``-inf``, and the top ``batch``
slots taken (the JAX ``replay_sample``). The imitation trainers store the
pre-aggregated delayed features ``delay_gso^T · delay_state`` ((K, N, F)
per step) and the expert action.
"""

from __future__ import annotations

from typing import Dict

import torch


class ReplayBuffer:
    """Ring buffer over a dict of fields.

    Attributes:
      data: field -> ``(capacity, ...)`` tensor.
      size: number of filled slots (setting it sets its device copy).
      cursor: next slot to write.
    """

    def __init__(self, capacity: int, example: Dict[str, torch.Tensor]):
        """Allocate ``capacity`` records shaped, typed and placed like
        ``example``'s fields."""
        self.data = {k: v.new_zeros((capacity, *v.shape))
                     for k, v in example.items()}
        dev = next(iter(self.data.values())).device
        self._slots = torch.arange(capacity, device=dev)
        self._size_dev = torch.zeros((), dtype=torch.int64, device=dev)
        self.size = 0
        self.cursor = 0

    @property
    def size(self) -> int:
        return self._size

    @size.setter
    def size(self, value: int) -> None:
        self._size = int(value)
        self._size_dev.fill_(self._size)

    @property
    def capacity(self) -> int:
        return next(iter(self.data.values())).shape[0]

    def insert(self, samples: Dict[str, torch.Tensor]) -> None:
        """Write ``T`` stacked records (leading axis) at the cursor, wrapping
        around; a chunk larger than the capacity raises ``ValueError``."""
        cap = self.capacity
        t = next(iter(samples.values())).shape[0]
        if t > cap:
            raise ValueError(f"chunk of {t} exceeds buffer capacity {cap}")
        dev = next(iter(self.data.values())).device
        idx = (torch.arange(t, device=dev) + self.cursor) % cap
        for k, d in self.data.items():
            d.index_copy_(0, idx, samples[k])
        self.size = min(self.size + t, cap)
        self.cursor = (self.cursor + t) % cap

    def sample(self, gen: torch.Generator,
               batch: int) -> Dict[str, torch.Tensor]:
        """``batch`` distinct filled records, uniformly, drawn from ``gen``."""
        u = torch.rand(self.capacity, generator=gen, device=gen.device)
        u = torch.where(self._slots < self._size_dev, u, float("-inf"))
        return self.gather(torch.topk(u, batch).indices)

    def gather(self, idx: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The records at slots ``idx``."""
        return {k: d.index_select(0, idx) for k, d in self.data.items()}
