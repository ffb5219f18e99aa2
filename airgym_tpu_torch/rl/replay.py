"""Off-policy replay buffers (counterpart of airgym_tpu/rl/replay.py;
reference lib/core/experience.py:8-277 and lib/core/segment_tree.py).

Unused by the PPO path, as in the reference; the library surface for
off-policy algorithms, in two halves:

  * ``ReplayBuffer`` / ``PrioritizedReplayBuffer`` and the array-based
    sum / min segment trees behind them: host-side numpy (float64 trees),
    drawing from the caller's ``np.random.Generator``, so that the same
    seed draws the same indices, weights and priorities as the JAX
    package's copies.
  * ``VectorizedReplayBuffer``: a ring buffer of torch tensors on one
    device, with the JAX API's functional shape (``create``,
    ``add(state, ...)``, ``sample(state, generator, batch_size)``).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from airgym_tpu_torch import device as device_mod


# --------------------------------------------------------------------------
# segment trees (array-based; reference segment_tree.py:3-133)


class SegmentTree:
    def __init__(self, capacity: int, neutral: float, op):
        assert capacity > 0 and capacity & (capacity - 1) == 0, \
            "capacity must be a power of 2"
        self.capacity = capacity
        self.neutral = neutral
        self.op = op
        self.tree = np.full(2 * capacity, neutral, dtype=np.float64)

    def __setitem__(self, idx, val):
        i = np.atleast_1d(np.asarray(idx)) + self.capacity
        self.tree[i] = val
        i //= 2
        while np.any(i >= 1):
            valid = i >= 1
            iv = np.unique(i[valid])
            if iv.size == 0:
                break
            self.tree[iv] = self.op(self.tree[2 * iv], self.tree[2 * iv + 1])
            i = iv // 2
        # root guard
        self.tree[0] = self.neutral

    def __getitem__(self, idx):
        return self.tree[np.asarray(idx) + self.capacity]

    def reduce(self):
        return self.tree[1]


class SumSegmentTree(SegmentTree):
    def __init__(self, capacity):
        super().__init__(capacity, 0.0, np.add)

    def find_prefixsum_idx(self, prefixsum):
        """Largest idx with sum(tree[:idx]) <= prefixsum (vectorized)."""
        ps = np.atleast_1d(np.asarray(prefixsum, dtype=np.float64)).copy()
        idx = np.ones(ps.shape, dtype=np.int64)
        while np.any(idx < self.capacity):
            left = 2 * idx
            go_right = self.tree[left] <= ps
            ps = np.where(go_right, ps - self.tree[left], ps)
            idx = np.where(idx < self.capacity,
                           np.where(go_right, left + 1, left), idx)
        return idx - self.capacity


class MinSegmentTree(SegmentTree):
    def __init__(self, capacity):
        super().__init__(capacity, np.inf, np.minimum)


# --------------------------------------------------------------------------
# host-side uniform / prioritized buffers (reference experience.py:8-198)


class ReplayBuffer:
    def __init__(self, size: int, obs_shape: Tuple[int, ...],
                 action_shape: Tuple[int, ...]):
        self._size = size
        self._next = 0
        self._count = 0
        self.obs = np.zeros((size,) + tuple(obs_shape), np.float32)
        self.next_obs = np.zeros_like(self.obs)
        self.actions = np.zeros((size,) + tuple(action_shape), np.float32)
        self.rewards = np.zeros((size,), np.float32)
        self.dones = np.zeros((size,), np.float32)

    def __len__(self):
        return self._count

    def add(self, obs, action, reward, next_obs, done):
        i = self._next
        self.obs[i] = obs
        self.actions[i] = action
        self.rewards[i] = reward
        self.next_obs[i] = next_obs
        self.dones[i] = done
        self._next = (i + 1) % self._size
        self._count = min(self._count + 1, self._size)
        return i

    def _encode(self, idx):
        return (self.obs[idx], self.actions[idx], self.rewards[idx],
                self.next_obs[idx], self.dones[idx])

    def sample(self, batch_size, rng: np.random.Generator | None = None):
        rng = rng or np.random.default_rng()
        idx = rng.integers(0, self._count, size=batch_size)
        return self._encode(idx)


class PrioritizedReplayBuffer(ReplayBuffer):
    """Proportional PER (reference experience.py:84-198)."""

    def __init__(self, size, alpha, obs_shape, action_shape):
        super().__init__(size, obs_shape, action_shape)
        assert alpha >= 0
        self._alpha = alpha
        cap = 1
        while cap < size:
            cap *= 2
        self._sum = SumSegmentTree(cap)
        self._min = MinSegmentTree(cap)
        self._max_priority = 1.0

    def add(self, *args, **kwargs):
        idx = super().add(*args, **kwargs)
        self._sum[idx] = self._max_priority ** self._alpha
        self._min[idx] = self._max_priority ** self._alpha
        return idx

    def sample(self, batch_size, beta, rng=None):
        assert beta > 0
        rng = rng or np.random.default_rng()
        total = self._sum.reduce()
        mass = rng.random(batch_size) * total
        idx = np.clip(self._sum.find_prefixsum_idx(mass), 0,
                      self._count - 1)
        p_min = self._min.reduce() / total
        max_weight = (p_min * self._count) ** (-beta)
        p_sample = self._sum[idx] / total
        weights = (p_sample * self._count) ** (-beta) / max_weight
        return self._encode(idx) + (weights.astype(np.float32), idx)

    def update_priorities(self, idxes, priorities):
        priorities = np.asarray(priorities, np.float64)
        assert np.all(priorities > 0)
        self._sum[idxes] = priorities ** self._alpha
        self._min[idxes] = priorities ** self._alpha
        self._max_priority = max(self._max_priority, priorities.max())


# --------------------------------------------------------------------------
# device-resident vectorized buffer (reference experience.py:199-277)


class VectorizedReplayState(NamedTuple):
    obs: torch.Tensor
    next_obs: torch.Tensor
    actions: torch.Tensor
    rewards: torch.Tensor
    dones: torch.Tensor
    idx: torch.Tensor       # 0-d int32 write cursor
    full: torch.Tensor      # 0-d bool: the ring has wrapped


class VectorizedReplayBuffer:
    """Batch-add ring buffer on ``device`` (default ``cuda``). ``add`` writes a batch into
    the state's tensors in place (a ring of hundreds of MB is not copied
    per add) and returns the state with the new cursor; the rows written
    are the cursor's next ones modulo the capacity, so a batch wraps."""

    def __init__(self, obs_shape, action_shape, capacity: int,
                 device=None):
        self.capacity = capacity
        self.obs_shape = tuple(obs_shape)
        self.action_shape = tuple(action_shape)
        self.device = device_mod.resolve(device)

    def create(self) -> VectorizedReplayState:
        c, kw = self.capacity, dict(dtype=torch.float32, device=self.device)
        return VectorizedReplayState(
            obs=torch.zeros((c,) + self.obs_shape, **kw),
            next_obs=torch.zeros((c,) + self.obs_shape, **kw),
            actions=torch.zeros((c,) + self.action_shape, **kw),
            rewards=torch.zeros((c,), **kw),
            dones=torch.zeros((c,), **kw),
            idx=torch.zeros((), dtype=torch.int32, device=self.device),
            full=torch.zeros((), dtype=torch.bool, device=self.device))

    def add(self, st: VectorizedReplayState, obs, action, reward, next_obs,
            done) -> VectorizedReplayState:
        n = obs.shape[0]
        if n > self.capacity:
            raise ValueError(f"a batch of {n} rows does not fit a ring of "
                             f"{self.capacity}")
        rows = (st.idx + torch.arange(n, device=self.device)) % self.capacity
        for buf, val in ((st.obs, obs), (st.next_obs, next_obs),
                         (st.actions, action), (st.rewards, reward),
                         (st.dones, done)):
            buf[rows] = torch.as_tensor(val, device=self.device).to(
                buf.dtype).reshape((n,) + buf.shape[1:])
        return st._replace(idx=((st.idx + n) % self.capacity).to(torch.int32),
                           full=st.full | (st.idx + n >= self.capacity))

    def size(self, st: VectorizedReplayState) -> torch.Tensor:
        return torch.where(st.full, self.capacity, st.idx)

    def sample(self, st: VectorizedReplayState, generator: torch.Generator,
               batch_size: int):
        """``batch_size`` stored rows drawn uniformly with replacement (row
        0 while the ring is empty); reads the size to the host once."""
        hi = max(int(self.size(st)), 1)
        idx = torch.randint(0, hi, (batch_size,), generator=generator,
                            device=self.device)
        return (st.obs[idx], st.actions[idx], st.rewards[idx],
                st.next_obs[idx], st.dones[idx])
