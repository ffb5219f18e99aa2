"""CLI entry point (counterpart of airgym_tpu/cli.py):

    python -m airgym_tpu_torch.cli --train --task planning \
        [--ctl_mode rate] [--num_envs N] [--seed S] [--file cfg.yaml] \
        [--experiment_name NAME] [--checkpoint path] [--device cuda|cpu]
        [--transfer_checkpoint src.pt --transfer_old_obs_dim D]
    python -m airgym_tpu_torch.cli --play --task hovering \
        --checkpoint runs/.../nn/last_ppo_hovering.pth \
        [--max_steps 1000] [--record_dir DIR] [--device cuda|cpu]

    torchrun --nproc_per_node=G -m airgym_tpu_torch.cli --train ...

Tasks: hovering, balloon, tracking, planning, avoid, maplanning (DepthGen
generates datasets: ``make_task("depthgen", num_envs=N).generate(out_dir,
n_frames)``, no training); a task added with ``envs.register`` (a
Customized subclass) trains from a YAML whose ``config.env_name`` names
it, given with --file. Uses the packaged
airgym_tpu_torch/configs/ppo_<task>.yaml unless --file is given; CLI
flags override YAML values (``update_config``). ``--train`` wins over
``--play``, and neither flag trains (``resolve_train``). ``--ctl_mode``
defaults to rate. ``--play`` evaluates a native ``.pt`` or reference
``.pth`` checkpoint and prints ``av reward: ... games played: ...``;
``--record_dir`` dumps the episode there (needs matplotlib). Runs on
``cuda`` unless ``--device cpu`` is given, and raises without a GPU.
Under ``torchrun`` each of the G processes trains its block of the envs
on ``cuda:LOCAL_RANK`` over NCCL (parallel/dist.py); rank 0 logs and
writes the checkpoints.
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
    p.add_argument("--train", action="store_true")
    p.add_argument("--play", action="store_true")
    p.add_argument("--num_envs", type=int, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--checkpoint", default=None,
                   help="native .pt or reference .pth checkpoint to "
                        "resume from or to play")
    p.add_argument("--experiment_name", default=None,
                   help="overrides config.name (the run directory's "
                        "prefix)")
    p.add_argument("--headless", action="store_true",
                   help="accepted for the reference CLI's sake; the port "
                        "has no viewer")
    p.add_argument("--file", default=None,
                   help="algorithm config YAML (default: packaged "
                        "configs/ppo_<task>.yaml)")
    p.add_argument("--max_steps", type=int, default=1000,
                   help="--play: steps to evaluate")
    p.add_argument("--record_dir", default=None,
                   help="--play: dump the episode here (trajectory.png, "
                        "depth.gif, episode.npz)")
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu")
    p.add_argument("--transfer_checkpoint", default=None,
                   help="--train: warm-start from this native .pt of "
                        "another obs-vector width (the robot-count "
                        "curriculum)")
    p.add_argument("--transfer_old_obs_dim", type=int, default=None,
                   help="the obs-vector width of --transfer_checkpoint")
    return p.parse_args(argv)


def resolve_train(args) -> bool:
    """--train wins over --play, and neither flag trains (the reference
    runner's else branch)."""
    return args.train or not args.play


def update_config(cfg, args):
    """Merge the CLI's overrides into the YAML config."""
    c = cfg["params"]["config"]
    if args.task:
        c["env_name"] = args.task
    if args.experiment_name:
        c["name"] = args.experiment_name
    if args.num_envs:
        c["num_actors"] = args.num_envs
    if args.seed is not None:
        cfg["params"]["seed"] = args.seed
    return cfg


def run_cli(argv=None):
    """Parse, run, and return the runner's result: (TrainState, info) for
    training, the eval dict for --play."""
    args = get_args(argv)
    cfg_path = args.file or os.path.join(CONFIG_DIR, f"ppo_{args.task}.yaml")
    with open(cfg_path) as f:
        cfg = yaml.safe_load(f)
    cfg = update_config(cfg, args)
    from airgym_tpu_torch.rl.runner import Runner
    return Runner().load(cfg).run({
        "train": resolve_train(args), "task": args.task,
        "ctl_mode": args.ctl_mode, "num_envs": args.num_envs,
        "seed": args.seed, "checkpoint": args.checkpoint,
        "max_steps": args.max_steps, "record_dir": args.record_dir,
        "device": args.device, "transfer_checkpoint": args.transfer_checkpoint,
        "transfer_old_obs_dim": args.transfer_old_obs_dim})


def main(argv=None):
    from airgym_tpu_torch.parallel import dist
    try:
        run_cli(argv)
    finally:
        dist.destroy()
    return 0


if __name__ == "__main__":
    main()
