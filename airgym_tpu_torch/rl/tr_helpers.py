"""Trainer helpers (counterpart of airgym_tpu/rl/tr_helpers.py; reference
lib/utils/tr_helpers.py and lib/core/torch_ext.py AverageMeter).

The trainer inlines its reward scaling; these are the library surface:
``DefaultRewardsShaper`` (scale / shift / clip, on tensors),
dict flattening, the unsqueeze helper, the windowed ``AverageMeter`` of
episode statistics and ``DatasetList``, host-side numpy like the JAX
module's.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


class DefaultRewardsShaper:
    """(tr_helpers.py:16-42): r -> clip(r * scale + shift, min, max),
    with an optional log before the clip; a tensor (or an array, made
    one) in, a tensor out."""

    def __init__(self, scale_value: float = 1.0, shift_value: float = 0.0,
                 min_val: float = -np.inf, max_val: float = np.inf,
                 log_val: bool = False):
        self.scale_value = scale_value
        self.shift_value = shift_value
        self.min_val = min_val
        self.max_val = max_val
        self.log_val = log_val

    def __call__(self, reward) -> torch.Tensor:
        reward = torch.as_tensor(reward) * self.scale_value + self.shift_value
        if self.log_val:
            reward = torch.log(reward)
        return torch.clamp(reward, self.min_val, self.max_val)


def dicts_to_dict_with_arrays(dicts, add_batch_dim=True):
    """(tr_helpers.py): list of dicts -> dict of stacked arrays."""
    def stack(v):
        return np.stack(v) if add_batch_dim else np.concatenate(v)

    keys = dicts[0].keys()
    return {k: stack([np.asarray(d[k]) for d in dicts]) for k in keys}


def unsqueeze_obs(obs):
    """(tr_helpers.py:73-80): add a batch dim to array or dict obs."""
    if isinstance(obs, dict):
        return {k: unsqueeze_obs(v) for k, v in obs.items()}
    return obs[None]


class AverageMeter:
    """Windowed running mean of episode statistics (torch_ext.py:270-297):
    update(batch of finished-episode values) folds into a capped-size
    running mean."""

    def __init__(self, in_shape=(), max_size: int = 100):
        self.max_size = max_size
        self.in_shape = in_shape
        self.clear()

    def clear(self):
        self.mean = np.zeros(self.in_shape, np.float64)
        self.current_size = 0

    def update(self, values):
        values = np.asarray(values, np.float64)
        size = values.shape[0] if values.ndim > len(self.in_shape) else 1
        if size == 0:
            return
        new_mean = values.mean(axis=0) if values.ndim > len(self.in_shape) \
            else values
        size = min(size, self.max_size)
        old_size = min(self.max_size - size, self.current_size)
        size_sum = old_size + size
        self.current_size = size_sum
        self.mean = (self.mean * old_size + new_mean * size) / size_sum

    def get_mean(self):
        return self.mean

    def __len__(self):
        return self.current_size


class DatasetList:
    """Concatenation view over several rollout datasets (reference
    lib/core/datasets.py:50-66): collect dicts of arrays from several
    sources, then iterate contiguous minibatches over the concatenation
    in the order they were added (no shuffle, as the reference)."""

    def __init__(self):
        self.datasets = []

    def add(self, dataset: Dict[str, Any]):
        self.datasets.append(dataset)

    def clear(self):
        self.datasets = []

    def concat(self) -> Dict[str, Any]:
        keys = self.datasets[0].keys()
        return {k: np.concatenate([np.asarray(d[k]) for d in self.datasets])
                for k in keys}

    def minibatches(self, minibatch_size: int):
        data = self.concat()
        n = len(next(iter(data.values())))
        for i in range(0, n - minibatch_size + 1, minibatch_size):
            yield {k: v[i:i + minibatch_size] for k, v in data.items()}
