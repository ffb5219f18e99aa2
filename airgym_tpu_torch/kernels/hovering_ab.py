"""B1, the env-only Hovering kernel (``csrc/fused_hovering.cu``), on one
card: this tree's build, its clock build, and optionally another version
of the source, such as an earlier commit's written out with ``git show``:

    mkdir -p build/other
    for f in fused_hovering.cu quad_step.cuh common.cuh; do
        git show HEAD~1:airgym_tpu_torch/csrc/$f > build/other/$f; done
    python -m airgym_tpu_torch.kernels.hovering_ab --other build/other/fused_hovering.cu

Two traffics at 131,072 envs from ``initial_state`` (seed 17) with
progress[:256] = 2380, so that time-outs fall inside every window:
climb, the remapped action [0.05, -0.05, 0.02, 0.4] (thrust 0.4, about
2.6 times the weight: every env climbs out of the box and resets), and
hover, bench.py's ``remap_actions([0, 0, 0, -0.7])`` (thrust 0.15, near
hover: resets are rare). For each: every build against the plain version
at 64 steps (max |err| of the state and the reward sums, progress /
reset flags equal, rows 29:40 unchanged, two launches bitwise equal),
the elements whose bits differ between the two builds, and both builds
timed in turns, other / this / this / other twice (climb x 64: median of
20 CUDA-event timings; hover x 8000, bench.py's length: median of 5,
with env-steps/s).

For this tree's build: registers, local memory, resident blocks per SM
and waves; the SASS of the step loop (``cuobjdump -sass``, static
counts: the loop body and the reset block behind the warp vote); from
the clock build (-DAIRGYM_HOVER_CLOCKS) the split of thread 0's cycles
per block and step, the warp-steps that ran the reset work and the
resets under each traffic; and the issue bound, instructions per step x
env-steps / 32 / (4 x SMs x SM clock), the SM clock read by nvidia-smi
under load. Needs a GPU; prints the card's name and power limit first.
The helpers are also chip_smoke.py's.
"""
from __future__ import annotations

import argparse
import ctypes
import math
import re
import statistics
import subprocess
from pathlib import Path

import torch

from airgym_tpu_torch.kernels import build
from airgym_tpu_torch.ops import fused_hovering as fh

N_ENVS, STEPS, LONG_STEPS = 131072, 64, 8000
REPS, LONG_REPS = 20, 5
SEED = 5
CLIMB = (0.05, -0.05, 0.02, 0.4)
PHASES = ("control + physics", "reward", "reset draws + quat", "reset mix")
# FP32 operations, counted by hand from csrc/quad_step.cuh, common.cuh and
# fused_hovering.cu (each add, multiply, division, square root,
# transcendental, comparison, minimum, maximum, absolute value and
# int-to-float conversion as one; selects and the hash's integer work not
# counted). Every env-step: the controller 138 (the rotation to the body
# 43, three PIDs 42, the mixer and yaw desaturation 53; the motor lag adds
# 12), the physics 177, the reward without its action terms 136 (its die
# test included) and the time-out test 1. Each reset: 137 (12 draws 57,
# quat_from_euler 25, the mix 55). Each env once: 57 (the thrust clip 2,
# the thrust term 4, the continuity term 17 for each of its three operand
# sets). The parent design's count: 580 for every env and step.
STEP_OPS = 138 + 177 + 136 + 1
RESET_OPS = 137
LAUNCH_OPS = 2 + 4 + 3 * 17
PARENT_STEP_OPS = 580
PEAK_FP32, PEAK_BYTES = 67e12, 3.35e12      # H100 SXM


def bound(n, steps, resets, step_ops=STEP_OPS):
    """(operations, bytes, least ms, what bounds it) of one launch: the
    state read and written once, the reward sums written once."""
    ops = step_ops * n * steps + RESET_OPS * resets + LAUNCH_OPS * n
    nbytes = 4.0 * (2 * fh.NROWS * n + n + 4)
    t_ops, t_bytes = ops / PEAK_FP32, nbytes / PEAK_BYTES
    return ops, nbytes, 1e3 * max(t_ops, t_bytes), \
        "operations" if t_ops >= t_bytes else "bytes"


def traffic(dev, n=N_ENVS):
    """The packed state and the two actions {climb, hover}."""
    from airgym_tpu_torch import envs
    task = envs.make_task("hovering", ctl_mode="rate", num_envs=n, device=dev)
    packed = fh.pack_state(task.initial_state(
        torch.Generator(device=dev).manual_seed(17)).core)
    packed[19, :256] = 2380.0
    hover = task.remap_actions(
        torch.tensor([[0.0, 0.0, 0.0, -0.7]], device=dev))[0].contiguous()
    return packed, {"climb": torch.tensor(CLIMB, device=dev), "hover": hover}


def kernel_build(source=None, clocks=False):
    """A build of ``source`` (this tree's by default; another version
    exports only the launch), with the phase clocks if ``clocks``."""
    entries = dict(fh.KERNEL.entry_points)
    if source is not None:
        entries = {"fused_hovering_launch": entries["fused_hovering_launch"]}
    if clocks:
        entries["fused_hovering_phase_cycles"] = [ctypes.c_void_p]
    k = build.CudaKernel("fused_hovering", entries,
                         ["-DAIRGYM_HOVER_CLOCKS"] if clocks else [])
    if source is not None:
        k.source = Path(source).resolve()
    return k


def run(kernel, packed, act, steps, seed=SEED):
    return fh._kernel_rollout(kernel, packed, act, seed, steps, 0.0)


def vs_plain(kernel, packed, act, steps, plain):
    """Two launches of ``kernel`` against the plain version's (out, rew):
    a dict of the errors and checks, with the first launch's output."""
    out, rew = run(kernel, packed, act, steps)
    out2, rew2 = run(kernel, packed, act, steps)
    torch.cuda.synchronize()
    out_p, rew_p = plain
    bits = lambda x: x.view(torch.int32)
    return {"state_err": float((out[:fh.NROWS] - out_p[:fh.NROWS]).abs().max()),
            "rew_err": float((rew - rew_p).abs().max()),
            "flags_equal": torch.equal(out[19:21], out_p[19:21]),
            "rows_kept": torch.equal(bits(out[fh.NROWS:]),
                                     bits(packed[fh.NROWS:])),
            "repeat_equal": torch.equal(bits(out), bits(out2))
            and torch.equal(bits(rew), bits(rew2)),
            "finite": bool(torch.isfinite(out[:fh.NROWS]).all()
                           and torch.isfinite(rew).all()),
            "out": out, "rew": rew}


def differing(a, b):
    """Elements of (out, rew) whose bits differ between two results."""
    return sum(int((x.view(torch.int32) != y.view(torch.int32)).sum())
               for x, y in zip(a, b))


def counts(kernel, fn):
    """Run ``fn`` once on the clock build -> (its seven counters: cycles
    of thread 0 of every block in each of PHASES, warp-steps that ran the
    reset work, resets, thread 0's cycles from its block's start to its
    end; the launch's ms by CUDA events)."""
    c = (ctypes.c_ulonglong * 7)()
    fn()                                              # warm-up
    torch.cuda.synchronize()
    kernel.call("fused_hovering_phase_cycles", c)      # reads and zeroes
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    fn()
    b.record()
    b.synchronize()
    kernel.call("fused_hovering_phase_cycles", c)
    return list(c), a.elapsed_time(b)


def block_mhz(c, ms, n):
    """A block's cycles from start to end over the launch's time: the SM
    clock in the run where the launch is long enough to hide its start
    and its tail."""
    return c[6] / (n // 128) / ms / 1e3


def split_line(c, ms, n, steps):
    """Cycles per block and step of each phase, with their shares; the
    share of warp-steps that ran the reset work; the resets; a block's
    cycles over the launch's time."""
    blocks = n // 128
    block_steps = max(blocks * steps, 1)
    total = max(sum(c[:4]), 1)
    parts = "; ".join(f"{name} {x / block_steps:.0f} ({100 * x / total:.1f}%)"
                      for name, x in zip(PHASES, c[:4]))
    return (f"{parts}; total {total / block_steps:.0f} cycles per block-step; "
            f"reset work in {100 * c[4] / max(n // 32 * steps, 1):.2f}% of "
            f"warp-steps; {c[5]} resets; a block {c[6] / blocks:.0f} cycles "
            f"in a {ms:.4f} ms launch: {block_mhz(c, ms, n):.0f} MHz")


def _branch_target(instr):
    m = re.search(r"\bBRA(?:\.\w+)*\s.*?(0x[0-9a-f]+)\s*$", instr)
    return int(m.group(1), 16) if m else None


def _cold(body):
    """Addresses of the body's cold paths: what a predicated forward
    branch skips around local-memory work (sinf / cosf's Payne-Hanek
    reduction) or around a slow-path CALL (IEEE division, square root)."""
    cold = set()
    for a, t in body:
        tgt = _branch_target(t)
        if tgt is None or tgt <= a or not t.startswith("@"):
            continue
        reg = [(x, u) for x, u in body if a < x < tgt]
        if (len(reg) < 200 and any("LDL" in u or "STL" in u for _, u in reg)) \
                or (len(reg) < 12 and any("CALL" in u for _, u in reg)):
            cold.update(x for x, _ in reg)
    return cold


def loop_sass(kernel):
    """Static SASS counts of ``kernel``'s fused_hovering_kernel:
    {"kernel", "loop", "hot", "reset", "hot_reset"}: the whole kernel; the
    step loop's body (the widest backward branch), and without its cold
    paths; the reset block behind the warp vote (between the first
    forward branch after a VOTE and its target, None without one), and
    without its cold paths. Empty without cuobjdump or without a loop."""
    ins = next((v for f, v in build.sass(kernel).items()
                if "fused_hovering_kernel" in f), None)
    if ins is None:
        return {}
    back = [(t, a) for a, txt in ins
            for t in [_branch_target(txt)] if t is not None and t <= a]
    if not back:
        return {}
    lo, hi = max(back, key=lambda ta: ta[1] - ta[0])
    body = [(a, t) for a, t in ins if lo <= a <= hi]
    cold = _cold(body)
    out = {"kernel": len(ins), "loop": len(body),
           "hot": len(body) - len(cold), "reset": None, "hot_reset": None}
    vote = next((i for i, (_, t) in enumerate(body) if t.startswith("VOTE")),
                None)
    for a, t in body[vote + 1:] if vote is not None else []:
        tgt = _branch_target(t)
        if tgt is not None and tgt > a:
            block = [x for x, _ in body if a < x < tgt]
            out["reset"] = len(block)
            out["hot_reset"] = len([x for x in block if x not in cold])
            break
    return out


def per_step(sass, c, n, steps):
    """Hot instructions a warp issues per step: the loop's, less the reset
    block's in the warp-steps that skipped it."""
    frac = c[4] / max(n // 32 * steps, 1)
    return sass["hot"] - (1.0 - frac) * (sass["hot_reset"] or 0)


def sm_clock_mhz(fn, calls):
    """The SM clock nvidia-smi reads while ``calls`` launches of ``fn``
    run, or None."""
    for _ in range(calls):
        fn()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    torch.cuda.synchronize()
    try:
        return float(smi.stdout.strip().splitlines()[0])
    except (ValueError, IndexError):
        return None


def issue_bound_ms(instr_per_step, n, steps, mhz):
    """Instructions per step x env-steps / 32 / (4 schedulers x SMs x
    clock): one warp instruction per scheduler and cycle."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return 1e3 * instr_per_step * n * steps / 32 / (4 * sms * mhz * 1e6)


def issue_line(sass, c, n, steps, clocks):
    """The hot instructions a warp issues per step and the issue bound at
    each of ``clocks`` ({label: MHz})."""
    instr = per_step(sass, c, n, steps)
    return (f"{instr:.0f} hot SASS instructions per warp-step -> issue bound "
            + ", ".join(f"{issue_bound_ms(instr, n, steps, mhz):.4f} ms at "
                        f"{mhz:.0f} MHz ({label})"
                        for label, mhz in clocks.items() if mhz))


def shape_line(kernel, n=N_ENVS):
    sh = fh.launch_shape(n, kernel)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    waves = sh["blocks"] / max(sh["per_sm"] * sms, 1)
    return sh, (f"{sh['threads']} threads x {sh['blocks']} blocks, "
                f"{sh['registers']} registers, {sh['local']} B local, "
                f"{sh['per_sm']} blocks per SM: {math.ceil(waves)} wave(s) "
                f"({waves:.3f})")


def time_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=Path,
                    help="another version of fused_hovering.cu (its "
                         "headers beside it)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("hovering_ab needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    dev = torch.device("cuda")
    builds = {"this": kernel_build()}
    if args.other:
        builds["other"] = kernel_build(args.other)
    clk = kernel_build(clocks=True)
    secs = build.build_all([*builds.values(), clk])
    print(f"[build] {len(builds) + 1} libraries in {secs:.1f} s", flush=True)
    for tag, k in [*builds.items(), ("this, clocks", clk)]:
        for line in k.build_log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build {tag}] {line.strip()}", flush=True)
    print(f"[shape this] {shape_line(builds['this'])[1]}", flush=True)
    sass = loop_sass(builds["this"])
    print(f"[sass this] {sass}", flush=True)
    lib = clk.lib()
    if hasattr(lib, "fused_hovering_sincos_mismatches"):
        bad = ctypes.c_ulonglong()
        lib.fused_hovering_sincos_mismatches.argtypes = [ctypes.c_void_p]
        clk.call("fused_hovering_sincos_mismatches", ctypes.byref(bad))
        print(f"[sincos] float bit patterns where sincosf differs from sinf / "
              f"cosf: {bad.value} of 2^32", flush=True)
    packed, acts = traffic(dev)
    mhz = sm_clock_mhz(lambda: run(builds["this"], packed, acts["hover"],
                                   LONG_STEPS), 20)
    print(f"[clock] SM clock under load {mhz} MHz (nvidia-smi)", flush=True)
    timed = {}
    for name, act in acts.items():
        plain = fh.rollout_fused_plain(packed, act, SEED, STEPS)
        res = {tag: vs_plain(k, packed, act, STEPS, plain)
               for tag, k in builds.items()}
        for tag, r in res.items():
            print(f"[{name}] {tag} vs plain at {N_ENVS} x {STEPS}: "
                  f"state {r['state_err']:.3e}, reward sums "
                  f"{r['rew_err']:.3e}; flags equal {r['flags_equal']}, rows "
                  f"29:40 kept {r['rows_kept']}, two launches bitwise equal "
                  f"{r['repeat_equal']}, finite {r['finite']}", flush=True)
        if "other" in res:
            o, t = res["other"], res["this"]
            print(f"[{name}] this vs other: "
                  f"{differing((t['out'], t['rew']), (o['out'], o['rew']))} "
                  f"of {t['out'].numel() + t['rew'].numel()} elements "
                  f"differ", flush=True)
        c, c_ms = counts(clk, lambda: run(clk, packed, act, STEPS))
        print(f"[{name}] clocks at {N_ENVS} x {STEPS}: "
              f"{split_line(c, c_ms, N_ENVS, STEPS)}", flush=True)
        ops, nbytes, b_ms, b_by = bound(N_ENVS, STEPS, c[5])
        print(f"[{name}] bound at {N_ENVS} x {STEPS}: {ops / 1e9:.3f} GFLOP "
              f"({c[5]} resets), {nbytes / 1e6:.2f} MB -> {b_ms:.4f} ms by "
              f"{b_by}; the parent design's count "
              f"{bound(N_ENVS, STEPS, 0, PARENT_STEP_OPS)[2]:.4f} ms",
              flush=True)
        steps, reps = (STEPS, REPS) if name == "climb" else (LONG_STEPS,
                                                            LONG_REPS)
        if steps != STEPS:
            c, c_ms = counts(clk, lambda: run(clk, packed, act, steps))
            print(f"[{name}] clocks at {N_ENVS} x {steps}: "
                  f"{split_line(c, c_ms, N_ENVS, steps)}", flush=True)
        timed[name] = (c, c_ms, steps)
        fns = {tag: (lambda k=k: run(k, packed, act, steps))
               for tag, k in builds.items()}
        order = ["other", "this", "this", "other"] * 2 if "other" in fns \
            else ["this"] * 2
        ms = {tag: [] for tag in fns}
        for tag in order:
            ms[tag].append(time_ms(fns[tag], reps))
        print(f"[{name}] {N_ENVS} x {steps} ms: " + "; ".join(
            f"{tag} " + " ".join(f"{x:.4f}" for x in v)
            for tag, v in ms.items()) + "; this "
            f"{N_ENVS * steps / statistics.median(ms['this']) / 1e6:.2f} G "
            f"env-steps/s", flush=True)
    # the clock in the run: the long hover launch's block cycles over its
    # time, beside what nvidia-smi reads under load
    c, c_ms, _ = timed["hover"]
    clocks = {"nvidia-smi": mhz, "clock build, hover x 8000":
              block_mhz(c, c_ms, N_ENVS)}
    for name, (c, _, steps) in timed.items():
        if sass:
            print(f"[{name}] {N_ENVS} x {steps}: "
                  f"{issue_line(sass, c, N_ENVS, steps, clocks)}", flush=True)


if __name__ == "__main__":
    main()
