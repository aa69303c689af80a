"""Structure-of-arrays replay buffer on the device.

The counterpart of the JAX package's ``algos/replay.py``: a preallocated
tensor per record field with leading dim ``capacity``, filled as a ring.
``size`` and ``cursor`` are Python ints, so the trainers' update gate
``size > batch_size`` never waits on the device. Each also has a device
copy, set with it: the sample masks with the device size, and
:meth:`ReplayBuffer.insert_device` writes at the device cursor and
advances both copies by device arithmetic, so that a sample or an insert
captured into a CUDA graph reads the buffer of each replay, not the one
at capture. After such inserts :meth:`ReplayBuffer.advance` brings the
host ints level, without a wait.

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
      cursor: next slot to write (setting it sets its device copy).
    """

    def __init__(self, capacity: int, example: Dict[str, torch.Tensor]):
        """Allocate ``capacity`` records shaped, typed and placed like
        ``example``'s fields."""
        self.data = {k: v.new_zeros((capacity, *v.shape))
                     for k, v in example.items()}
        dev = next(iter(self.data.values())).device
        self._slots = torch.arange(capacity, device=dev)
        self._size_dev = torch.zeros((), dtype=torch.int64, device=dev)
        self._cursor_dev = torch.zeros((), dtype=torch.int64, device=dev)
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
    def cursor(self) -> int:
        return self._cursor

    @cursor.setter
    def cursor(self, value: int) -> None:
        self._cursor = int(value)
        self._cursor_dev.fill_(self._cursor)

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

    def insert_device(self, samples: Dict[str, torch.Tensor]) -> None:
        """:meth:`insert`'s writes at the device cursor, which advances with
        the device size by device arithmetic alone (no host value is read
        or written: a CUDA graph may hold it); :meth:`advance` then brings
        the host ints level."""
        cap = self.capacity
        t = next(iter(samples.values())).shape[0]
        if t > cap:
            raise ValueError(f"chunk of {t} exceeds buffer capacity {cap}")
        idx = (torch.arange(t, device=self._slots.device)
               + self._cursor_dev) % cap
        for k, d in self.data.items():
            d.index_copy_(0, idx, samples[k])
        self._size_dev.add_(t).clamp_(max=cap)
        self._cursor_dev.add_(t).remainder_(cap)

    def advance(self, t: int) -> None:
        """The host ints after ``t`` records written by
        :meth:`insert_device` (their device copies already moved)."""
        self._size = min(self._size + t, self.capacity)
        self._cursor = (self._cursor + t) % self.capacity

    def sample(self, gen: torch.Generator,
               batch: int) -> Dict[str, torch.Tensor]:
        """``batch`` distinct filled records, uniformly, drawn from ``gen``."""
        u = torch.rand(self.capacity, generator=gen, device=gen.device)
        u = torch.where(self._slots < self._size_dev, u, float("-inf"))
        return self.gather(torch.topk(u, batch).indices)

    def gather(self, idx: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The records at slots ``idx``."""
        return {k: d.index_select(0, idx) for k, d in self.data.items()}
