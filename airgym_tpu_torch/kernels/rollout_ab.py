"""Two builds of ``csrc/fused_rollout.cu`` on one card: this tree's and
another version of the source, such as an earlier commit's written out
with ``git show <commit>:airgym_tpu_torch/csrc/fused_rollout.cu``.

    python -m airgym_tpu_torch.kernels.rollout_ab --other build/other/fused_rollout.cu

For each fused task at 4096 envs and its YAML's horizon (obs noise on,
256 envs at the time-out, motor alpha 0): each build against the plain
version (max |err|, done / timeout flags equal), the two builds against
each other (elements that differ in the record and the state, max
|diff|, and by record row at the first step that differs), and both
timed in turns, other / this / this / other twice (CUDA events, median
of 20 launches each). Then the default Hovering trainer
(``configs/ppo_hovering.yaml``, 4096 envs) trains with each build in
turn: ``PAIRS`` pairs of warm epochs, the order alternating, each epoch's
wall on the host clock up to ``torch.cuda.synchronize()``. The other
source must export the same ``fused_rollout_launch``. Needs a GPU;
prints the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import statistics
import subprocess
import time
from pathlib import Path

import torch
import yaml

from airgym_tpu_torch import envs
from airgym_tpu_torch.kernels import build
from airgym_tpu_torch.models.actor_critic import ActorCritic
from airgym_tpu_torch.ops import fused_hovering as fh
from airgym_tpu_torch.ops import fused_rollout as fr
from airgym_tpu_torch.rl.fused_ppo import FusedHoveringPPO
from airgym_tpu_torch.rl.runner import ppo_config_from_params
from airgym_tpu_torch.rl.running_stats import RunningMeanStd

HORIZON = {"hovering": 24, "balloon": 32, "tracking": 24}  # the YAMLs'
N_ENVS, REPS, PAIRS = 4096, 20, 20


def time_ms(fn):
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(REPS):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)


def inputs(task, dev):
    t = envs.make_task(task, ctl_mode="rate", num_envs=N_ENVS, device=dev)
    state = t.initial_state(torch.Generator(device=dev).manual_seed(11))
    model = ActorCritic(t.num_obs, 4, generator=torch.Generator()
                        .manual_seed(3)).to(dev)
    rms = RunningMeanStd.create((t.num_obs,), dev).update(
        torch.randn((4096, t.num_obs), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(5)))
    if task == "balloon":
        p = fr.pack_state_balloon(state.core, state.balloon,
                                  state.pre_root_pos)
    else:
        p = fh.pack_state(state.core)
    p[19, :256] = fr._TASK_MAX_LEN[task] - 4.0
    return p, fr.pack_policy(model, rms)


def epoch_walls(kernels, dev):
    """Warm-epoch walls (ms) of the default Hovering trainer with each
    build as ``fr.KERNEL``, in alternating pairs."""
    cfg_path = Path(fr.__file__).resolve().parent.parent / "configs" \
        / "ppo_hovering.yaml"
    params = yaml.safe_load(cfg_path.read_text())["params"]
    task = envs.make_task("hovering", ctl_mode="rate",
                          num_envs=int(params["config"]["num_actors"]),
                          device=dev)
    trainer = FusedHoveringPPO(task, ppo_config_from_params(params))
    ts = trainer.init(1234)
    walls = {tag: [] for tag in kernels}
    this = fr.KERNEL
    try:
        for i in range(PAIRS + 1):
            order = list(kernels) if i % 2 else list(kernels)[::-1]
            for tag in order:
                fr.KERNEL = kernels[tag]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                ts = trainer.train_epoch(ts)[0]
                torch.cuda.synchronize()
                if i:                       # the first pair warms up
                    walls[tag].append(1e3 * (time.perf_counter() - t0))
    finally:
        fr.KERNEL = this
    return walls


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True, type=Path)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("rollout_ab needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    dev = torch.device("cuda")
    launch = fr.KERNEL.entry_points["fused_rollout_launch"]
    other = build.CudaKernel("fused_rollout",
                             {"fused_rollout_launch": launch})
    other.source = args.other.resolve()
    kernels = {"this": fr.KERNEL, "other": other}
    build.build_all(kernels.values())
    for tag, k in kernels.items():
        for line in k.build_log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build {tag}] {line.strip()}", flush=True)
    seed = 987654321
    stream = torch.cuda.current_stream().cuda_stream
    for task, steps in HORIZON.items():
        packed, pack = inputs(task, dev)
        obs = fr._TASK_OBS[task]
        own = 35 if task == "balloon" else 29
        fns = {tag: (lambda k=k: fr._kernel_rollout(
            k, stream, packed, pack, seed, steps, True, task, 0.0))
            for tag, k in kernels.items()}
        res = {tag: fn() for tag, fn in fns.items()}
        out_p, rec_p = fr.rollout_fused_policy_plain(packed, pack, seed,
                                                     steps, task=task)
        torch.cuda.synchronize()
        for tag, (out, rec) in res.items():
            flags = torch.equal(rec[:, obs + 11:obs + 13],
                                rec_p[:, obs + 11:obs + 13])
            err = max(float((rec - rec_p).abs().max()),
                      float((out[:own] - out_p[:own]).abs().max()))
            print(f"[{task}] {tag}: max|err| vs plain {err:.3e}, flags "
                  f"equal {flags}", flush=True)
        (out, rec), (o_out, o_rec) = res["this"], res["other"]
        ne = (rec.view(torch.int32) != o_rec.view(torch.int32)).sum(2)
        d_out = int((out.view(torch.int32) != o_out.view(torch.int32)).sum())
        diff = max(float((rec - o_rec).abs().max()),
                   float((out[:own] - o_out[:own]).abs().max()))
        print(f"[{task}] this vs other: {int(ne.sum())} of {rec.numel()} "
              f"record and {d_out} of {out.numel()} state elements differ, "
              f"max|diff| {diff:.3e}", flush=True)
        steps_diff = torch.nonzero(ne.sum(1)).flatten().tolist()
        if steps_diff:
            s0 = steps_diff[0]
            rows = {r: int(c) for r, c in enumerate(ne[s0].tolist()) if c}
            print(f"[{task}] this vs other: first at step {s0}, differing "
                  f"envs by record row {rows}", flush=True)
        ms = {tag: [] for tag in fns}
        for tag in ["other", "this", "this", "other"] * 2:
            ms[tag].append(time_ms(fns[tag]))
        print(f"[{task}] {N_ENVS} x {steps} ms: " + "; ".join(
            f"{tag} " + " ".join(f"{x:.3f}" for x in v)
            for tag, v in ms.items()), flush=True)
        print(f"[{task}] this launch shape {fr.launch_shape(task, N_ENVS)}",
              flush=True)
    walls = epoch_walls(kernels, dev)
    for tag, v in walls.items():
        q = statistics.quantiles(v, n=4)
        print(f"[epoch hovering] {tag}: warm epoch wall median "
              f"{statistics.median(v):.3f} ms, quartiles {q[0]:.3f} / "
              f"{q[2]:.3f} ms over {len(v)} epochs", flush=True)
    wins = sum(a < b for a, b in zip(walls["this"], walls["other"]))
    print(f"[epoch hovering] this faster in {wins} of {PAIRS} pairs",
          flush=True)


if __name__ == "__main__":
    main()
