"""Episode state / reward logger for debugging (counterpart of
airgym_tpu/utils/logger.py; reference airgym/utils/logger.py:36-60, the
matplotlib plots of logged states and rewards). Host-side; values may be
numbers, numpy scalars or one-element tensors. Plotting saves to a file
and imports matplotlib only there."""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List

import numpy as np
import torch


def _host(value) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu().numpy()
    return np.asarray(value)


class EpisodeLogger:
    def __init__(self, dt: float):
        self.dt = dt
        self.state_log: Dict[str, List[float]] = defaultdict(list)
        self.rew_log: Dict[str, List[float]] = defaultdict(list)
        self.num_episodes = 0

    def log_state(self, key: str, value):
        self.state_log[key].append(float(_host(value)))

    def log_states(self, d: Dict[str, float]):
        for k, v in d.items():
            self.log_state(k, v)

    def log_rewards(self, d: Dict[str, np.ndarray], num_episodes: int):
        for k, v in d.items():
            self.rew_log[k].append(float(np.sum(_host(v))))
        self.num_episodes += num_episodes

    def reset(self):
        self.state_log.clear()
        self.rew_log.clear()
        self.num_episodes = 0

    def print_rewards(self):
        print("Average rewards per second:")
        for k, values in self.rew_log.items():
            mean = np.sum(np.array(values)) / max(self.num_episodes, 1)
            print(f" - {k}: {mean:.4f}")
        print(f"Total number of episodes: {self.num_episodes}")

    def plot_states(self, out_path: str = "episode_states.png"):
        """One panel per logged state against time, saved to ``out_path``
        (which is returned); None when nothing was logged. Needs
        matplotlib."""
        keys = sorted(self.state_log)
        if not keys:
            return None
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        n = len(keys)
        cols = min(3, n)
        rows = (n + cols - 1) // cols
        fig, axes = plt.subplots(rows, cols, figsize=(4 * cols, 3 * rows),
                                 squeeze=False)
        for i, k in enumerate(keys):
            ax = axes[i // cols][i % cols]
            y = self.state_log[k]
            ax.plot(np.arange(len(y)) * self.dt, y)
            ax.set_title(k)
            ax.set_xlabel("t [s]")
        fig.tight_layout()
        fig.savefig(out_path)
        plt.close(fig)
        return out_path
