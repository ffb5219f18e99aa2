"""The plain reference of an env-only cell: the frozen copy's Hovering
task makes the env batch from the seed, and the env-only rollout's plain
version (csrc/fused_hovering.cu's loop, from the step pieces of
``plain/ops/fused_hovering``) steps a sample of its envs.

Each env steps alone (no term couples two envs) and draws from its own
hash-RNG stream, keyed by its tile and lane, so a sample of envs, from
any calls at once, steps as it would in the whole batch. A step's tensor
ops are captured once in a CUDA graph and replayed (on a CUDA device);
the graph runs the same ops in the same order as the eager loop.
"""
from __future__ import annotations

import torch

from portbench.reference.plain import envs
from portbench.reference.plain.ops import fused_hovering as fh
from portbench.reference.plain.ops import hash_rng as hr


def initial(num_envs: int, seed: int, action, device):
    """(packed state [40, N], remapped action [4]) as the cell makes them."""
    task = envs.make_task("hovering", num_envs, device, obs_noise=False)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    s0 = task.initial_state(gen)
    act = task.remap_actions(torch.tensor([action], dtype=torch.float32,
                                          device=device))[0]
    return fh.pack_state(s0.core), act


class _Step:
    """One env step of csrc/fused_hovering.cu on static tensors: the rows
    and reward sums are read from and written back to ``self.rows`` and
    ``self.rew``; the step's hash key enters through ``self.key``."""

    def __init__(self, packed, action, call_seeds, env_idx, store=None):
        dev = packed.device
        self.store = store
        self.rows = packed[0:fh.NROWS].clone()
        self.rew = torch.zeros(packed.shape[1], dtype=torch.float32,
                               device=dev)
        tile = env_idx // fh.TILE
        self.base = ((call_seeds & hr.M32)
                     + hr.mulmod(tile, 0x01000193)) & hr.M32
        self.lanes = env_idx % fh.TILE
        self.key = torch.zeros((), dtype=torch.int64, device=dev)
        self.a = [action[k] for k in range(4)]
        self.thrust = torch.clamp(self.a[3], fh.G.thrust_min,
                                  fh.G.thrust_max)

    def __call__(self):
        a0, a1, a2, a3 = self.a
        s = fh.Rows(self.rows)
        c = fh.control_physics(s, a0, a1, a2, self.thrust, env_only=True)
        reward, die = fh.hover_reward(s, a0, a1, a2, a3, c)
        rew = self.rew + reward
        one = torch.ones_like(s.pa0)
        s.pa0, s.pa1, s.pa2, s.pa3 = a0 * one, a1 * one, a2 * one, a3 * one
        new_rstf = (die | (s.prog >= fh.HOVER_MAX_LEN - 1)).to(
            torch.float32)
        fh.apply_reset(s, new_rstf, fh.reset_root(
            hr.make_uniform(self.base ^ self.key, self.lanes)))
        rows = s.stack()
        if self.store is not None:          # the control's lower precision
            rows, rew = rows.to(self.store), rew.to(self.store)
        self.rows.copy_(rows)
        self.rew.copy_(rew)


def follow(packed, action, call_seeds, env_idx, steps: int, graph=True,
           store=None):
    """The sample's (rows [29, S], reward sums [S]) after ``steps`` steps:
    column j is env ``env_idx[j]`` of the call seeded ``call_seeds[j]``,
    started from ``packed[:, j]``. ``store`` = torch.bfloat16 rounds the
    state and the sums to bf16 after each step: the control."""
    step = _Step(packed, action, call_seeds, env_idx, store)
    keys = [hr.mulmod(i + 1, 0x9E3779B1) for i in range(steps)]
    if not (graph and packed.is_cuda):
        for k in keys:
            step.key.fill_(k)
            step()
        return step.rows, step.rew
    rows0, rew0 = step.rows.clone(), step.rew.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()                                   # warm the allocator
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        step()
    step.rows.copy_(rows0)
    step.rew.copy_(rew0)
    key_dev = torch.tensor(keys, dtype=torch.int64, device=packed.device)
    for i in range(steps):
        step.key.copy_(key_dev[i])
        g.replay()
    torch.cuda.synchronize()
    return step.rows, step.rew
