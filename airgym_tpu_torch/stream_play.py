"""Play a checkpoint with the runtime action / state stream attached
(counterpart of scripts/stream_play.py; the reference's optional rospy
bridge, hovering.py:149-156,362-366; the protocol is in
``utils/action_stream.py``).

    python -m airgym_tpu_torch.stream_play --checkpoint runs/<run>/nn/<ckpt>.pth \\
        [--task hovering] [--ctl_mode rate] [--num_envs 16] [--port 7781] \\
        [--steps 2000] [--hz 100] [--seed 0] [--device cuda|cpu]

The task and its trainer are built from the packaged
``configs/ppo_<task>.yaml``, as the CLI's ``--play`` builds them, so a
native ``.pt`` or reference ``.pth`` that the CLI wrote restores; without
``--checkpoint`` the policy is untrained. Runs on ``cuda`` unless
``--device cpu`` is given, and raises without a GPU. Consume the stream
from another terminal:

    nc 127.0.0.1 7781                      # watch actions / state
    echo '{"target_state": [1,0,0,0,1,0,0,0,1, 2,1,1.5, 0,0,0,0,0,0]}' \\
        | nc 127.0.0.1 7781                # re-target all envs mid-flight
"""
from __future__ import annotations

import argparse
import os
import sys

import yaml

from airgym_tpu_torch.cli import CONFIG_DIR
from airgym_tpu_torch.rl import runner as runner_mod
from airgym_tpu_torch.utils.action_stream import (ActionStreamServer,
                                                  run_bridged_play)


def get_args(argv=None):
    p = argparse.ArgumentParser("airgym_tpu_torch stream_play")
    p.add_argument("--checkpoint", default=None,
                   help="native .pt or reference .pth; untrained policy "
                        "when omitted")
    p.add_argument("--task", default="hovering")
    p.add_argument("--ctl_mode", default="rate",
                   choices=["pos", "vel", "atti", "rate", "prop"])
    p.add_argument("--num_envs", type=int, default=16)
    p.add_argument("--port", type=int, default=7781)
    p.add_argument("--steps", type=int, default=2000)
    p.add_argument("--hz", type=float, default=100.0,
                   help="control rate pacing; 0 = as fast as possible")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None) -> int:
    a = get_args(argv)
    with open(os.path.join(CONFIG_DIR, f"ppo_{a.task}.yaml")) as f:
        cfg = yaml.safe_load(f)
    runner = runner_mod.Runner().load(cfg)
    task, trainer, _ = runner.build({
        "task": a.task, "ctl_mode": a.ctl_mode, "num_envs": a.num_envs,
        "seed": a.seed, "device": a.device})
    ts = trainer.init(0)
    if a.checkpoint:
        ts = runner_mod.restore(ts, a.checkpoint)

    server = ActionStreamServer(port=a.port)
    print(f"streaming on {server.address}; send "
          f'{{"target_state": [...18]}} lines to re-target', flush=True)
    try:
        run_bridged_play(task, trainer, ts, server, steps=a.steps,
                         seed=a.seed, realtime_hz=a.hz or None,
                         device=a.device)
    finally:
        server.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
