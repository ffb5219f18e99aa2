"""Vec-env adaptation layer (counterpart of airgym_tpu/rl/vecenv.py).

The glue between an RL library and the task layer, on the port's own
``envs``:
  * a ``configurations`` registry mapping env names to creators, filled
    for every registered task;
  * ``create_vec_env(name, num_actors, **kwargs)``;
  * ``AirGymVecEnv`` with the IVecEnv surface: step / reset /
    get_env_info / get_number_of_agents / get/set_env_state;
  * ``ExtractObsWrapper`` dropping the privileged obs;
  * obs spaces: Dict{image, observation} when the task has a camera, Box
    otherwise; actions are [-1, 1]^n.

Spaces are small local classes (no gym dependency) with the ``.shape`` /
``.low`` / ``.high`` / ``.spaces`` attributes a trainer reads.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np

from airgym_tpu_torch import envs


class Box:
    def __init__(self, low, high, shape):
        self.shape = tuple(shape)
        self.low = np.broadcast_to(np.asarray(low, np.float32), self.shape)
        self.high = np.broadcast_to(np.asarray(high, np.float32), self.shape)


class DictSpace:
    def __init__(self, spaces: Dict[str, Any]):
        self.spaces = spaces

    def __getitem__(self, k):
        return self.spaces[k]


configurations: Dict[str, Dict[str, Any]] = {}


def register(name: str, config: Dict[str, Any]) -> None:
    configurations[name] = config


class ExtractObsWrapper:
    """Drops the privileged observations from the step / reset tuples."""

    def __init__(self, env):
        self.env = env

    def __getattr__(self, item):
        return getattr(self.env, item)

    def reset(self):
        obs, _priv = self.env.reset()
        return obs

    def step(self, actions):
        obs, _priv, rew, reset, extras = self.env.step(actions)
        return obs, rew, reset, extras


class AirGymVecEnv:
    """IVecEnv over a ``TaskWrapper``."""

    def __init__(self, config_name: str, num_actors: int, **kwargs):
        creator = configurations[config_name]["env_creator"]
        self.env = ExtractObsWrapper(creator(num_envs=num_actors, **kwargs))

    def step(self, actions):
        return self.env.step(actions)

    def reset(self):
        return self.env.reset()

    def get_number_of_agents(self) -> int:
        return getattr(self.env.task.cfg, "num_agents", 1)

    def get_env_info(self) -> Dict[str, Any]:
        task = self.env.task
        action_space = Box(-1.0, 1.0, (task.cfg.num_actions,))
        if task.obs_is_dict:
            spec = task.obs_spec
            obs_space = DictSpace({
                "image": Box(-np.inf, np.inf, spec["image"][1:]),
                "observation": Box(-np.inf, np.inf, spec["observation"][1:]),
            })
        else:
            obs_space = Box(-np.inf, np.inf, (task.num_obs,))
        return {"observation_space": obs_space, "action_space": action_space,
                "agents": self.get_number_of_agents(), "value_size": 1}

    def get_env_state(self):
        return None

    def set_env_state(self, state):
        pass


def create_vec_env(name: str, num_actors: int, **kwargs) -> AirGymVecEnv:
    return AirGymVecEnv(name, num_actors, **kwargs)


# every registered task
for _name in envs.registered_tasks():
    register(_name, {
        "vecenv_type": "AIRGYM",
        "env_creator": (lambda name: (
            lambda **kw: envs.make_env(name, **kw)))(_name),
    })
