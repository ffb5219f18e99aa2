"""CLI entry point (counterpart of airgym_tpu/cli.py, train only):

    python -m airgym_tpu_torch.cli --train --task planning \
        [--ctl_mode rate] [--num_envs N] [--seed S] [--file cfg.yaml] \
        [--device cuda|cpu]

Tasks: hovering, balloon, tracking, planning, avoid, maplanning (DepthGen
generates datasets: ``make_task("depthgen", num_envs=N).generate(out_dir,
n_frames)``, no training). Uses the packaged
airgym_tpu_torch/configs/ppo_<task>.yaml unless --file is given; CLI
flags override YAML values. ``--ctl_mode`` defaults to rate, the only
mode ported. Runs on ``cuda`` unless ``--device cpu`` is given, and
raises without a GPU.
"""
from __future__ import annotations

import argparse
import os

import yaml

CONFIG_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "configs")


def get_args(argv=None):
    p = argparse.ArgumentParser("airgym_tpu_torch runner")
    p.add_argument("--task", default="hovering")
    p.add_argument("--ctl_mode", default="rate",
                   choices=["pos", "vel", "atti", "rate", "prop"])
    p.add_argument("--train", action="store_true",
                   help="train (the only mode this port runs so far)")
    p.add_argument("--num_envs", type=int, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--checkpoint", default=None,
                   help="native .pt or reference .pth checkpoint to "
                        "resume from")
    p.add_argument("--file", default=None,
                   help="algorithm config YAML (default: packaged "
                        "configs/ppo_<task>.yaml)")
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu")
    return p.parse_args(argv)


def run_cli(argv=None):
    args = get_args(argv)
    cfg_path = args.file or os.path.join(CONFIG_DIR, f"ppo_{args.task}.yaml")
    with open(cfg_path) as f:
        cfg = yaml.safe_load(f)
    c = cfg["params"]["config"]
    c["env_name"] = args.task
    if args.num_envs:
        c["num_actors"] = args.num_envs
    from airgym_tpu_torch.rl.runner import Runner
    return Runner().load(cfg).run({
        "train": True, "task": args.task, "ctl_mode": args.ctl_mode,
        "num_envs": args.num_envs, "seed": args.seed,
        "checkpoint": args.checkpoint, "device": args.device})


def main(argv=None):
    run_cli(argv)
    return 0


if __name__ == "__main__":
    main()
