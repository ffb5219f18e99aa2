#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (airgym_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:
  1. print the card's name and power limit (nvidia-smi);
  2. build every CUDA kernel from csrc/ with nvcc (one process per source,
     started together) and print each kernel's registers and spills; the
     two render sources once more with -DAIRGYM_RENDER_CLOCKS, and the
     SASS instruction count of each record kind's cast body in that build
     (cuobjdump -sass) beside the parent design's; the env-only source
     once more with -DAIRGYM_HOVER_CLOCKS, and the env-only kernel's
     registers, blocks per SM and waves at 131,072 envs and the SASS of
     its step loop and of the reset block behind its warp vote;
  3. hold the Hovering rollout kernel against its plain PyTorch version at
     the main-path shape (4096 envs x 24 steps, obs noise on), two kernel
     runs on the same inputs bitwise equal;
  4. hold the update kernel (18 features) against its plain version at
     the main-path shape (B = 98,304, minibatch 2048, 48 minibatches,
     5 mini-epochs: 240 Adam steps in one cooperative launch), two kernel
     runs on the same inputs bitwise equal; then the prep kernels
     (csrc/epoch_prep.cu: GAE, the running stats, the dataset) at 4096
     envs x 24 steps with dones and time-outs, at 18 and 48 features,
     against their plain twin on the same card tensors, bitwise, two calls
     bitwise equal, three launches a call;
  5. train the default Hovering PPO (configs/ppo_hovering.yaml, 4096
     envs) for a few epochs through the runner, with the kernels' launch
     counters set to 0 just before and read just after (1 rollout, 1 gae,
     1 stats, 1 dataset and 1 update launch per epoch; the Adam count 240
     per epoch), then save and reload the checkpoint;
  6. time each kernel and its plain version with CUDA events, the update
     kernel's persistent grid G printed beside its time and bound, and the
     update once more with G capped at half; the rollout's launch shape
     (envs and threads per block, blocks, resident blocks per SM) beside
     its time, and the split of its blocks' cycles between the env phases
     and the MLP (a second build of the source with
     -DAIRGYM_ROLLOUT_CLOCKS); each prep kernel's device time (the
     profiler, at 18 and 48 features) beside its plain phase's (CUDA
     events) and its byte bound, and the chain's whole time;
  7. profile one steady epoch (device busy share, device time by kernel,
     exactly one update kernel and one of each prep kernel);
  8. hold the Balloon (4096 x 32) and Tracking (4096 x 24) rollout
     kernels against their plain versions, with resets, time-outs and
     balloon hits in the window, two kernel runs bitwise equal, the update
     kernel at 18 features against its plain version at Balloon's shape
     (B = 131,072, 64 minibatches) and at 48 features at B = 98,304, each
     with two bitwise-equal kernel runs;
  9. hold the env-only Hovering kernel against its plain version at 4096
     envs x 64 steps with resets, then drive it once at 131,072 envs x 64
     under the climb action (counters set to 0 before, read after) and
     hold that run, and one under the reference bench's hover action,
     against the plain version too, each with a second launch bitwise
     equal (kernels/hovering_ab.py's two traffics);
 10. train Balloon (configs/ppo_balloon.yaml at 4096 envs) and Tracking
     (configs/ppo_tracking.yaml) for 3 epochs each through the runner,
     counters checked (1 rollout, 1 of each prep kernel and 1 update
     launch per epoch; the Adam count 320 / 240 per epoch), save and
     reload each, and profile one epoch each (exactly one update kernel
     and one of each prep kernel);
 11. time the Balloon / Tracking kernels and the 48-feature update (with
     its G) and their plain versions, the Balloon / Tracking rollouts with
     their launch shapes and cycle split as in phase 6; the env-only
     kernel under both traffics (climb x 64 beside its plain version;
     hover x 8000, bench.py's length, the kernel alone, in env-steps/s),
     each with its clock build's cycle split, its bound counted from this
     source with the window's resets beside the parent design's count,
     and its issue bound;
 12. hold the fused render + post-process kernel against its plain
     version: at Planning's full shape (4096 envs, 212 x 120, 40 trees, a
     goal ball and the ground, culled at 4.5 m, after some env steps), on
     a one-box scene like Avoid's (too small to cull: the unguarded
     chain) and on a 256-env scene of all four record kinds; the split of
     a block's cycles between the prepass, the cast, the two noises and
     the blur on the Planning and box scenes (the clock build);
 13. train Planning (configs/ppo_planning.yaml, 4096 envs) for 2 epochs
     through the runner with the render counter set to 0 before and read
     after (1 launch at init, 6 per epoch), save and reload the
     checkpoint, and profile one epoch (render, convs, the rest);
 14. time the render kernel and its plain version (Planning culled and
     unculled, the box scene), the bound beside the parent design's bound
     and the kernel beside the parent's time;
 15. hold the raw depth kernel against its plain version: at MAPlanning's
     full shape (4096 envs x 4 robots = 16,384 cameras of 212 x 120,
     after 30 env steps), at DepthGen's 1024-env scene of 168 records
     (unguarded) and on a 256-env mixed scene culled at 4.5 m;
 16. train MAPlanning (configs/ppo_maplanning.yaml at its full width,
     16,384 actors) for 1 epoch through the runner, counters checked (1
     raw depth launch at init, 6 per epoch, nothing else), save and reload,
     print the peak device memory, profile one epoch (raw depth, convs,
     the rest);
 17. train Avoid (configs/ppo_avoid.yaml, 4096 envs) for 1 epoch (the
     render + process kernel: 1 launch at init, 16 per epoch), save and
     reload, profile one epoch;
 18. generate DepthGen's dataset at 1024 envs, 2048 frames (2 raw depth
     launches) and check every frame;
 19. time the raw depth kernel and its plain version at the MAPlanning
     and DepthGen shapes, the bound beside the parent design's and the
     kernel beside the parent's time, and a block's cycles split between
     the prepass and the cast;
 20. hold the fused CNN kernels against their plain versions at the
     Planning path's shapes: the forward at B = 4096 x 212 x 120 in bf16
     (the rollout's encodes), forward + backward at B = 609 (a minibatch's
     unique frames) in bf16 (forward and backward on mma.sync tensor cores)
     and at B = 64 in float32 (scalar), two forward runs and two backward
     runs bitwise equal;
 21. train Planning (configs/ppo_planning.yaml, 4096 envs) for 2 epochs
     through the runner's epoch loop with the trainer
     PPO(network_kw={..., "cnn_impl": "pallas"}): every metric finite,
     the launch counts (forward 8 + 240, backward 240, render 6 per
     epoch, render 1 at init), no cuDNN convolution in the profiled epoch,
     save and reload, peak device memory;
 22. time both CNN kernels and their plain versions beside their bounds
     (the bf16 forward at B = 4096 and 609 and the bf16 backward beside
     the scalar kernels' times they replaced, with their workspace bytes),
     and the cuDNN stack (impl='auto') at the same
     shapes as a yardstick;
 23. train Hovering to its YAML's end through the CLI (4096 envs, all 200
     epochs, 50 logged points; 1 rollout, 1 of each prep kernel and 1
     update launch per epoch),
     print its reward at the 1st, 10th, 25th and last logged points beside
     the reference's curve at the same frames
     (benchmarks/convergence/hovering.json), check the run's
     events.jsonl, then --play its .pth at 4096 envs for 1000 steps (no
     kernel launched): games, reward per game, env-steps/s;
 24. train Balloon (configs/ppo_balloon.yaml at 4096 envs, 200 epochs)
     with the fused trainer through the runner, then --play it at the
     reference eval's shape (1024 envs x 2000 steps, seed 7;
     benchmarks/convergence/balloon_eval.json): success >= 0.30 over >= 500
     games, printed beside the reference's 0.4883 over 37,176;
 25. --play phase 13's Planning checkpoint at 256 envs, seed 7, 400 steps
     (planning_eval.json's envs and seed) with the render + process
     kernel's counter set to 0 before and read after: the launches the
     env's render cadence gives, nothing else; env-steps/s;
 26. play Hovering at 4096 envs for 100 steps with a fresh policy in each
     of pos, vel, atti (5 actions) and prop, then train it in vel for 2
     epochs through the CLI (the plain trainer: no kernel launched) and
     --play that checkpoint for 100 steps;
 27. train Hovering (its YAML at 4096 envs) through the CLI with
     separate: True, fixed_sigma: False and activation tanh for 3 epochs
     (the plain trainer: no kernel launched), check its .pth's keys
     (critic_mlp.*, logstd.weight / .bias, no logstd) and --play it for
     100 steps; ms per epoch;
 28. train Planning (its YAML at 4096 envs, 212 x 120) for 1 epoch
     through the runner with a vae: block in place of the CNN, whose
     model_file this phase writes (a seeded VAE state dict, keys prefixed
     module. / dronet.): the grafted encoder equals the file's before and
     after the epoch, the render + process kernel launched as the cadence
     gives (counters set to 0 before, read after), the .pth without the
     encoder; ms per epoch, peak device memory;
 29. as 28 with a resnet: block and a torchvision-layout resnet18 file
     (3-channel conv1, BatchNorm2d statistics, downsample.0 / .1): the
     backbone unchanged by the epoch, fc trained;
 30. train MAPlanning (its YAML at 4096 envs) for 1 epoch at 2 robots,
     transfer the checkpoint into the YAML's 4 robots
     (checkpoint.transfer_obs_width): mu / sigma / value on zero-padded
     robot channels equal the source's within 1e-6 of max|ref|; then the
     runner's transfer_checkpoint branch trains 1 epoch; raw depth
     launches counted in both runs;
 31. train Customized (Planning's YAML network and PPO blocks, env_name
     customized, an empty env_config: 4096 envs, 212 x 120, eight thin
     trees over 8 x 8 m) for 1 epoch through the runner: the render +
     process kernel launched as the cadence gives and nothing else, the
     images of 8 envs of the run's last state against the plain pipeline,
     and a forced reset of env 0 that leaves every other env's scene and
     asset states bitwise unchanged; ms per epoch, peak device memory;
 32. the same at 212 x 240, a camera taller than 126 rows: the raw depth
     kernel launched as the cadence gives and the render + process
     kernel never, its raw depth on 8 envs against its plain version, no
     pixel index shared by two pixels, the image moments beside phase
     31's;
 33. multi-GPU over torch.distributed (parallel/dist.dryrun): two ranks
     on this card over gloo (over NCCL where the machine has two cards)
     train Hovering's YAML at 4096 envs for 2 epochs (the rollout kernel
     on each rank) and Planning's at 4096 envs for 1 epoch (the render +
     process kernel on each rank), each held to a one-process run of the
     same seed (Hovering's with the plain update the ranks take) within
     tests/test_multichip.py's tolerances (Hovering on its first epoch;
     the second's differences printed), the ranks' parameters bitwise
     equal, rank 0 alone writing; then one rank over NCCL trains
     Hovering for 1 epoch, bitwise the one-process epoch;
 34. the host-side C++ PX4 cascade (control/native.py, built with g++
     under build/native) at Hovering's 4096 envs in all five modes for 50
     steps of seeded random states and actions, a reset mask every 10
     steps, against px4.run on the card: commands and state within 2e-4;
     the g++ build's seconds and the ms per step of each;
 35. the library on the card against the CPU (within 1e-6 of max|ref|):
     the losses at 2048 x 4, the three moving-stats updates over 98,304,
     TensorPID over 4096 x 3; a VectorizedReplayBuffer of 2^20 rows of
     Hovering's transitions (176 MB) filled by 4096-env adds past one
     wrap, bitwise the CPU ring, sampled at 2048 (only stored rows); its
     ms per add and per sample;
 36. the action / state stream (utils/action_stream.py): run_bridged_play
     from phase 5's checkpoint at 4096 envs for 300 steps, a loopback
     client sending a target before the run and reading every line: 300
     whole lines in step order, bitwise a replay of the same boot with the
     target from step 1; steps/s; then stream_play.main --device cuda
     --steps 50 --hz 0 against a client; phases 34-36 launch no kernel;
and print one JSON line listing every ported kernel.
The last line is {"ok": true, "device": {...}}. Imports nothing of JAX.
"""
import contextlib
import ctypes
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# tolerances of the kernel-vs-plain comparisons: float32 with other
# summation orders in the MLP (measured ~2e-6 on an H100); the update's
# and the env-only kernel's are those of the JAX suite's tests
ROLLOUT_ATOL = 1e-4
UPDATE_PARAM_RTOL = 2e-3        # of max |ref| per tensor, + 1e-5
METRIC_RTOL, METRIC_ATOL = 5e-3, 5e-4
ENV_STATE_ATOL, ENV_REWARD_ATOL = 1e-4, 1e-3
EPOCHS = 4                      # Hovering
TASK_EPOCHS = 3                 # Balloon, Tracking
TIMING_REPS = 20                # kernels; plain versions take PLAIN_REPS
PLAIN_REPS = 5

# H100 SXM: 67 TFLOP/s FP32 outside the tensor cores, 989 TFLOP/s of bf16
# on the tensor cores (dense), 3.35 TB/s HBM3
PEAK_FP32 = 67e12
PEAK_BF16 = 989e12
PEAK_BYTES = 3.35e12
# the env-only kernel's FP32 operations are counted in
# airgym_tpu_torch/kernels/hovering_ab.py (per env-step, per reset, per
# env once), its bound from the resets the run makes; the parent design's
# times (kernels/hovering_ab.py on an H100 80GB HBM3 at 700 W), printed
# beside the redesigned kernel's: climb x 64, hover x 8000
PARENT_ENV_MS = {"climb": 0.4224, "hover": 43.08}
# FP32 operations of the two render kernels, counted by hand from
# csrc/raycast.cuh, csrc/render_process.cu and csrc/render_depth.cu: each
# add, multiply, division, square root, log, cosine, comparison, minimum,
# maximum, absolute value and int-to-float conversion as one; selects,
# negations and the hash's integer work not counted. Per pixel: the ray
# from the ray tables (3 adds, |d|^2, 1 / sqrtf, the Newton step, the unit
# direction) 18; the ground 5 where the scene has it; the raw depth's
# t * inv_norm 1; render + process's clip / normalise and block maximum 5
# and each noise 17 (two draws, Box-Muller, the clip, the maximum). Per tap
# of the blur inside the image 2. Per pixel and cast record (a valid
# record in a live group): cylinder 36, sphere 13, box 32, annulus 60. Per
# cast record and env, the prepass's struct: 22, 11, 16, 30. Per env, the
# ray tables: 11 a pixel column, 8 a pixel row.
RAY_OPS = 18
GROUND_OPS = 5
DEPTH_OUT_OPS = 1
PROCESS_PIXEL_OPS = 5 + 2 * 17
BLUR_TAP_OPS = 2
CAST_OPS = (36, 13, 32, 60)
PREP_OPS = (22, 11, 16, 30)
TABLE_OPS = (11, 8)
# the previous design's counts (every term recomputed per pixel and
# record): per pixel the ray and the ground 37 and the post-processing 80,
# per pixel and live record 58 / 20 / 45 / 90; the old bound, printed
# beside the new
OLD_RAY_OPS = 37
OLD_PIXEL_OPS = OLD_RAY_OPS + 80
OLD_RECORD_OPS = (58, 20, 45, 90)
# the previous design's kernel times (this script's phases 14 and 19 on
# an H100 80GB HBM3 at 700 W) and its SASS counts (cuobjdump -sass of its
# sources built with the same clocks), printed beside the redesigned
# kernels'
PARENT_RENDER_MS = {"culled": 10.920, "unculled": 21.446}
PARENT_DEPTH_MS = {"maplanning": 7.312, "depthgen": 10.824}
PARENT_CAST_SASS = {"cylinder": 231, "sphere": 81, "box": 264,
                    "annulus": 347}
RENDER_ATOL = 1e-5              # the JAX suite's (tests/test_fused_render.py)
PLANNING_EPOCHS = 2
# profiler kernel names of the CNN's cuDNN convolutions and their layout
# copies
CONV_WORDS = ("conv", "cudnn", "implicit", "wgrad", "dgrad", "fprop",
              "winograd", "nchw", "nhwc", "im2col")
# the raw depth kernel: |err| where both hit; a miss is BIG * inv_norm
# (>= 5e8), so a pixel is a hit below DEPTH_HIT
DEPTH_ATOL = 1e-5
DEPTH_HIT = 1e8
# at the YAML's full width (16,384 actors) / 4096 envs; one epoch each
# keeps the whole run under ten minutes
MAPLANNING_EPOCHS = 1
AVOID_EPOCHS = 1
DEPTHGEN_ENVS, DEPTHGEN_FRAMES = 1024, 2048
# the fused CNN kernels vs their plain versions, of max|ref|: float32 sums
# in another order (forward / gradients); bf16 also flips a few roundings
# of the activations and of g0 / g1 / g2 (measured ~2e-5 / ~1e-4 on an
# H100)
CNN_FWD_TOL = {torch.float32: 2e-5, torch.bfloat16: 1e-3}
# the times of the scalar bf16 kernels that the tensor-core ones replaced
# (this script's phase 22 on an H100 80GB HBM3 at 700 W), printed beside
# the new kernels': the backward at B = 609, the forward at B = 4096 and
# B = 609
SCALAR_BWD_MS = 10.369
SCALAR_FWD_MS = {4096: 16.865, 609: 2.675}
CNN_BWD_TOL = {torch.float32: 2e-4, torch.bfloat16: 1e-2}
# device kernels of cuDNN convolutions and their layout copies, none of
# which may run on the cnn_impl='pallas' path
CUDNN_WORDS = ("cudnn", "fprop", "dgrad", "wgrad", "implicit_gemm",
               "nchwtonhwc", "nhwctonchw", "winograd", "convolve")


# the reference's own training outcomes, set beside the port's (results
# of training, not speeds)
CONVERGENCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "benchmarks", "convergence")
# the Balloon eval's gate: success rate over at least this many games (the
# reference's own curve passed 0.43 by 7.9 M frames, balloon_long.json;
# an untrained policy scores near 0)
BALLOON_SUCCESS_MIN, BALLOON_GAMES_MIN = 0.30, 500
HOVER_PLAY_STEPS = 1000
PLANNING_PLAY_ENVS, PLANNING_PLAY_STEPS = 256, 400
MODE_PLAY_STEPS, MODE_TRAIN_EPOCHS = 100, 2
OPTION_EPOCHS, OPTION_PLAY_STEPS = 3, 100       # phase 27
# phase 30: the policy on zero-padded robot channels against the source's,
# of max|ref| (float32 products over another input width)
TRANSFER_RTOL = 1e-6
# phases 31-32: Customized at the Planning YAML's width, and its camera
# taller than the fused kernel's 126 rows
CUSTOM_ENVS, TALL_HEIGHT = 4096, 240
# phase 33: the metrics of a run's gathered rollout, set before its first
# Adam step
ROLLOUT_METRICS = ("mean_reward", "mean_ep_length", "reward_raw_per_step",
                   "explained_variance", "success_rate")
# phase 34: the native cascade at Hovering's YAML width, against px4.run
# on the card (tests/test_native_cascade.py's tolerance)
NATIVE_ENVS, NATIVE_STEPS, NATIVE_RESET_EVERY, NATIVE_ATOL = 4096, 50, 10, 2e-4
# phase 35: the library on the card against the CPU, of max|ref|; the
# losses at Hovering's minibatch, the moving stats over its batch, the
# replay ring at 2^20 rows of Hovering's transitions
LIB_RTOL = 1e-6
LIB_MINIBATCH, LIB_BATCH, LIB_ACTIONS = 2048, 98_304, 4
REPLAY_CAPACITY, REPLAY_ADDS, REPLAY_SAMPLE = 2 ** 20, 300, 2048
# phase 36: the stream's target, inside the survival envelope (dist > 4 m
# kills) and yawed by 0.3 rad, and the bridged run's length
STREAM_STEPS, STREAM_SEED = 300, 36
STREAM_TARGET = [math.cos(0.3), -math.sin(0.3), 0.0, math.sin(0.3),
                 math.cos(0.3), 0.0, 0.0, 0.0, 1.0, 1.0, -0.5, 0.5,
                 0.0, 0.0, 0.0, 0.0, 0.0, 0.0]

T0 = time.time()


def phase(n):
    """Print the script's elapsed seconds as phase ``n`` starts."""
    print(f"[phase {n}] starts at {time.time() - T0:.1f} s", flush=True)


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def cuda_time_ms(fn, reps=TIMING_REPS):
    """Median of ``reps`` CUDA-event timings of ``fn`` after one warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound_ms(flops, nbytes, peak=PEAK_FP32):
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def mlp_macs(obs):
    """MACs of one forward pass of the [64,128,64] net to mu(4) + value."""
    return 64 * obs + 128 * 64 + 64 * 128 + 5 * 64


def rollout_bound(task, n, steps, n_weights):
    from airgym_tpu_torch.ops import fused_rollout as fr
    flops = 2.0 * mlp_macs(fr._TASK_OBS[task]) * n * steps
    nbytes = 4.0 * (2 * fr._F * n + steps * fr.rec_len(task) * n + n_weights)
    return bound_ms(flops, nbytes)


def update_bound(obs, B, mini_epochs):
    from airgym_tpu_torch.ops import fused_update as fu
    # forward, weight gradients, input gradients (none into the obs)
    per_sample = 2.0 * (2 * mlp_macs(obs) + mlp_macs(obs) - 64 * obs)
    nbytes = 4.0 * (B * (obs + 4 + 3 + 4) + 6 * fu.num_params(obs))
    return bound_ms(per_sample * B * mini_epochs, nbytes)


def reset_counts(kernels):
    for k in kernels:
        k.launches.clear()


def rollout_vs_plain(fr, packed, pack, seed, steps, task, alpha=0.0):
    """Kernel vs plain on the same inputs; returns (max err, resets,
    timeouts, hits)."""
    out_k, rec_k = fr.rollout_fused_policy(packed, pack, seed, steps,
                                           obs_noise=True, task=task,
                                           motor_alpha=alpha)
    out_k2, rec_k2 = fr.rollout_fused_policy(packed, pack, seed, steps,
                                             obs_noise=True, task=task,
                                             motor_alpha=alpha)
    out_p, rec_p = fr.rollout_fused_policy_plain(packed, pack, seed, steps,
                                                 obs_noise=True, task=task,
                                                 motor_alpha=alpha)
    torch.cuda.synchronize()
    check(torch.equal(rec_k.view(torch.int32), rec_k2.view(torch.int32))
          and torch.equal(out_k.view(torch.int32), out_k2.view(torch.int32)),
          f"{task} rollout: two kernel runs on the same inputs differ "
          f"(alpha={alpha})")
    obs = fr._TASK_OBS[task]
    fl = slice(obs + 11, obs + 13)
    flags_k, flags_p = rec_k[:, fl], rec_p[:, fl]
    check(torch.equal(flags_k, flags_p),
          f"{task} rollout done/timeout flags differ (alpha={alpha}): "
          f"{int((flags_k != flags_p).sum())} of {flags_k.numel()}")
    check(bool(torch.isfinite(rec_k).all()), f"{task} record not finite")
    own = 35 if task == "balloon" else 29
    err_rec = float((rec_k - rec_p).abs().max())
    err_st = float((out_k[:own] - out_p[:own]).abs().max())
    check(torch.equal(out_k[own:], packed[own:]),
          f"{task} rollout changed rows it does not own")
    n_reset = int(flags_p[:, 0].sum())
    n_timeout = int(flags_p[:, 1].sum())
    n_hit = int((rec_p[:, obs + 10] > 400.0).sum()) if task == "balloon" \
        else 0
    print(f"[rollout {task}] alpha={alpha} {packed.shape[1]}x{steps}: "
          f"max|rec err| {err_rec:.3e} max|state err| {err_st:.3e} resets "
          f"{n_reset} timeouts {n_timeout} hits {n_hit}; two kernel runs "
          f"bitwise equal", flush=True)
    check(err_rec <= ROLLOUT_ATOL and err_st <= ROLLOUT_ATOL,
          f"{task} rollout kernel disagrees with its plain version beyond "
          f"atol {ROLLOUT_ATOL}")
    return max(err_rec, err_st), n_reset, n_timeout, n_hit


def rollout_shape_and_split(fr, fr_clk, task, packed, pack, seed, steps,
                            times):
    """Phases 6 and 11: the rollout's launch shape beside its time, plain
    time and bound, and where a block's cycles go (thread 0 of every
    block, summed: (a) the observation, (b) + (c) the MLP and heads, (d)
    the env step), from the build with -DAIRGYM_ROLLOUT_CLOCKS."""
    k_ms, p_ms, b_ms, b_by = times[task]
    sh = fr.launch_shape(task, packed.shape[1])
    cyc = (ctypes.c_ulonglong * 3)()
    fr_clk.call("fused_rollout_phase_cycles", cyc)          # zeroes them
    fr._kernel_rollout(fr_clk, torch.cuda.current_stream().cuda_stream,
                       packed, pack, seed, steps, True, task, 0.0)
    torch.cuda.synchronize()
    fr_clk.call("fused_rollout_phase_cycles", cyc)
    total = max(sum(cyc), 1)
    per_step = [c / (sh["blocks"] * max(steps, 1)) for c in cyc]
    print(f"[time] {task}: kernel {k_ms:.3f} ms (E={sh['envs']} envs x "
          f"{sh['threads']} threads per block, {sh['blocks']} blocks, "
          f"{sh['per_sm']} per SM, {sh['smem']} B shared; plain "
          f"{p_ms:.3f}, bound {b_ms:.4f} by {b_by})", flush=True)
    print(f"[time] {task}: a block's cycles per step: observation "
          f"{per_step[0]:.0f} ({100 * cyc[0] / total:.1f}%), MLP + heads "
          f"{per_step[1]:.0f} ({100 * cyc[1] / total:.1f}%), env step "
          f"{per_step[2]:.0f} ({100 * cyc[2] / total:.1f}%)", flush=True)


def env_vs_plain(fh, packed, act, seed, steps, out_k, rew_k, tag):
    """The env-only kernel's result (out_k, rew_k) vs its plain version on
    the same inputs, and vs a second launch (bitwise); returns (max state
    err, max reward-sum err)."""
    out_k2, rew_k2 = fh.rollout_fused(packed, act, seed, steps)
    out_p, rew_p = fh.rollout_fused_plain(packed, act, seed, steps)
    torch.cuda.synchronize()
    n = packed.shape[1]
    bits = lambda x: x.view(torch.int32)
    check(torch.equal(bits(out_k), bits(out_k2))
          and torch.equal(bits(rew_k), bits(rew_k2)),
          f"env-only kernel ({tag}) at {n}x{steps}: two launches differ")
    check(torch.equal(out_k[19:21], out_p[19:21]),
          f"env-only kernel ({tag}) at {n}x{steps}: progress / reset flags "
          f"differ from plain")
    env_err = float((out_k[:29] - out_p[:29]).abs().max())
    rew_err = float((rew_k - rew_p).abs().max())
    n_fresh = int((out_p[19] < steps).sum())
    print(f"[env-only {tag}] {n}x{steps}: max|state err| {env_err:.3e} "
          f"max|reward-sum err| {rew_err:.3e} envs reset in the window "
          f"{n_fresh}; two launches bitwise equal", flush=True)
    check(n_fresh > 0, f"env-only window ({tag}) at {n}x{steps} has no resets")
    check(env_err <= ENV_STATE_ATOL and rew_err <= ENV_REWARD_ATOL,
          f"env-only kernel ({tag}) disagrees with its plain version at "
          f"{n}x{steps}")
    check(torch.equal(bits(out_k[29:]), bits(packed[29:])),
          "env-only kernel changed rows 29:40")
    return env_err, rew_err


def update_case(fu, model, obs_rms, g, B, obs_dim, lr, pcfg, nmb):
    """Random dataset at the main path's shape, from the model's policy."""
    dev = lr.device
    obs = torch.randn((B, obs_dim), generator=g, device=dev)
    with torch.no_grad():
        mu0, sigma, _ = model(obs, obs_rms)
    logstd = model.logstd.detach()
    actions = mu0 + sigma * torch.randn(mu0.shape, generator=g, device=dev)
    d = (actions - mu0) / sigma
    nlp = (0.5 * (d * d).sum(-1) + 0.5 * math.log(2 * math.pi) * 4
           + logstd.sum())
    adv = torch.randn((B,), generator=g, device=dev)
    ret = torch.randn((B,), generator=g, device=dev)
    named = dict(model.named_parameters())
    zero = {k: torch.zeros_like(v.detach()) for k, v in named.items()}
    kcfg = dict(e_clip=pcfg.e_clip, critic_coef=pcfg.critic_coef,
                bounds_coef=pcfg.bounds_loss_coef,
                entropy_coef=pcfg.entropy_coef,
                truncate_grads=pcfg.truncate_grads, grad_norm=pcfg.grad_norm,
                adaptive_lr=True, kl_threshold=pcfg.kl_threshold,
                min_lr=pcfg.min_lr, max_lr=pcfg.max_lr)
    args = (obs_rms.normalize(obs), actions, adv, ret, nlp, mu0,
            torch.exp(logstd).reshape(-1, 1), fu.pack_update(named),
            fu.pack_update(zero), fu.pack_update(zero), lr.reshape(1),
            torch.zeros(1, device=dev))
    return args, dict(nmb=nmb, mini_epochs=pcfg.mini_epochs, cfg=kcfg)


def update_vs_plain(fu, args, kw, tag):
    res_k = fu.fused_update(*args, **kw)
    res_k2 = fu.fused_update(*args, **kw)
    res_p = fu.fused_update_plain(*args, **kw)
    torch.cuda.synchronize()
    # one cooperative launch per call; every sum in a fixed order
    check(all(torch.equal(fu.flatten(a), fu.flatten(b))
              for a, b in zip(res_k[:3], res_k2[:3]))
          and torch.equal(res_k[3], res_k2[3])
          and all(torch.equal(res_k[5][k], res_k2[5][k]) for k in fu.METRICS),
          f"update {tag}: two kernel runs on the same inputs differ")
    update_err = 0.0
    for which, (pk, pp) in zip(("params", "m", "v"),
                               zip(res_k[:3], res_p[:3])):
        for f in fu._FIELDS:
            a, b = getattr(pp, f), getattr(pk, f)
            scale = max(float(a.abs().max()), 1e-3)
            err = float((a - b).abs().max())
            if which == "params":
                update_err = max(update_err, err)
            check(err < UPDATE_PARAM_RTOL * scale + 1e-5,
                  f"update {tag} {which}.{f}: max|err| {err:.3e} vs scale "
                  f"{scale:.3e}")
    check(math.isclose(float(res_k[3]), float(res_p[3]), rel_tol=1e-6),
          f"update {tag} lr {float(res_k[3])} vs {float(res_p[3])}")
    check(float(res_k[4]) == float(res_p[4]),
          f"update {tag} count {float(res_k[4])} vs {float(res_p[4])}")
    for key in fu.METRICS:
        a, b = float(res_p[5][key]), float(res_k[5][key])
        check(math.isfinite(b) and abs(a - b) <= METRIC_ATOL
              + METRIC_RTOL * abs(a),
              f"update {tag} metric {key}: kernel {b} vs plain {a}")
    B = args[0].shape[0]
    grid = fu.grid_size(args[0].shape[1], args[0].device)
    print(f"[update {tag}] B={B} mb={B // kw['nmb']} nmb={kw['nmb']} "
          f"mini_epochs={kw['mini_epochs']} G={grid}: "
          f"max|param err| {update_err:.3e} lr {float(res_k[3]):.3e} count "
          f"{float(res_k[4]):.0f} kl {float(res_k[5]['kl']):.3e}; two "
          f"kernel runs bitwise equal", flush=True)
    return update_err


def prep_case(dev, obs, n, h, seed):
    """A record [h, obs + 13, n] as the rollout kernel writes it (about 4%
    of the steps end an episode, half of those by time-out), a bootstrap
    value and used running stats."""
    from airgym_tpu_torch.rl.running_stats import RunningMeanStd
    g = torch.Generator(device=dev).manual_seed(seed)
    rnd = lambda *shape: torch.randn(shape, generator=g, device=dev)
    uni = lambda *shape: torch.rand(shape, generator=g, device=dev)
    rec = rnd(h, obs + 13, n)
    rec[:, obs + 10] = 10.0 * uni(h, n) - 2.0
    done = uni(h, n) < 0.04
    rec[:, obs + 11] = done.float()
    rec[:, obs + 12] = (done & (uni(h, n) < 0.5)).float()
    obs_rms = RunningMeanStd.create((obs,), dev).update(
        2.0 * rnd(4096, obs) + 0.5)
    value_rms = RunningMeanStd.create((), dev).update(3.0 * rnd(4096) - 1.0)
    return rec, rnd(n), obs_rms, value_rms


# the outputs of each prep kernel (ops/epoch_prep.Prep's fields)
PREP_OUT = {"gae": ("values", "adv", "returns"),
            "stats": ("obs_rms", "value_rms"),
            "dataset": ("obs_n", "actions", "neglogp", "mus", "adv_n",
                        "returns_n")}


def prep_vs_plain(ep, case, kw, tag):
    """The three prep kernels against their plain twin on the same card
    tensors: bitwise, two calls bitwise equal, one launch of each a call.
    Returns {phase: max|err|}."""
    before = {ph: ep.KERNEL.launches.get(ph, 0) for ph in ep.PHASES}
    k1, k2 = ep.epoch_prep(*case, **kw), ep.epoch_prep(*case, **kw)
    p = ep.epoch_prep_plain(*case, **kw)
    torch.cuda.synchronize()
    got = {ph: ep.KERNEL.launches[ph] - before[ph] for ph in ep.PHASES}
    check(all(n == 2 for n in got.values()),
          f"prep {tag}: launches in two calls {got}, expected 2 of each")
    tensors = lambda x: (list(x) if isinstance(x, tuple) else [x])
    errs = {}
    for phase, fields in PREP_OUT.items():
        err = 0.0
        for f in fields:
            for w, a, b in zip(*(tensors(getattr(x, f)) for x in (p, k1, k2))):
                check(w.shape == a.shape and w.dtype == a.dtype,
                      f"prep {tag} {f}: {tuple(a.shape)} {a.dtype}, plain "
                      f"{tuple(w.shape)} {w.dtype}")
                check(torch.equal(a, b), f"prep {tag} {f}: two kernel "
                                         f"calls on the same inputs differ")
                err = max(err, float((a.double() - w.double()).abs().max()))
                check(torch.equal(a, w), f"prep {tag} {phase} {f}: kernel "
                                         f"vs plain twin max|err| {err:.3e}, "
                                         f"want bitwise equal")
        errs[phase] = err
    rec = case[0]
    print(f"[prep {tag}] {rec.shape[2]} envs x {rec.shape[0]} steps, "
          f"{int(rec[:, -2].sum())} dones ({int(rec[:, -1].sum())} "
          f"time-outs): gae, stats and dataset bitwise the plain twin; two "
          f"calls bitwise equal", flush=True)
    return errs


def prep_bound(obs, n, h):
    """{phase: (bound ms, 'bytes')}: the bytes each prep kernel has to move
    at least. gae reads the record's K observation rows and the value,
    reward, done and time-out rows and the bootstrap value, writes values,
    adv and returns and the float64 partials; stats reads the partials;
    dataset reads the K + 9 rows it copies and adv and returns, and writes
    K + 11 floats a row. Their float64 and float32 operations take less
    than a tenth of that time at the card's peaks."""
    hn, part = h * n, 8.0 * 3 * (n // 32) * (obs + 3)
    nbytes = {"gae": 4.0 * ((obs + 4) * hn + n + 3 * hn) + part,
              "stats": part,
              "dataset": 4.0 * 2 * (obs + 11) * hn}
    return {ph: bound_ms(0.0, b) for ph, b in nbytes.items()}


def prep_times(ep, case, kw, times, tag):
    """Each prep kernel's device time (the profiler over TIMING_REPS calls)
    beside its plain phase's (CUDA events) and its bound, into
    ``times[f"prep_{phase}[{tag}]"]``; and the chain's whole time."""
    from torch.profiler import ProfilerActivity, profile
    rec, last_value, obs_rms, value_rms = case
    for _ in range(3):
        ep.epoch_prep(*case, **kw)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(TIMING_REPS):
            ep.epoch_prep(*case, **kw)
        torch.cuda.synchronize()
    dev_ms = {}
    for e in prof.key_averages():
        for ph in ep.PHASES:
            if f"epoch_prep_{ph}_kernel" in e.key and e.count:
                dev_ms[ph] = e.device_time_total / e.count / 1e3
    check(sorted(dev_ms) == sorted(ep.PHASES),
          f"prep {tag}: the profiler saw {sorted(dev_ms)} of the kernels")
    values, adv, ret, part = ep.plain_gae(rec, last_value, value_rms, **kw)
    _, _, consts = ep.plain_stats(part, obs_rms, value_rms)
    plain = {"gae": lambda: ep.plain_gae(rec, last_value, value_rms, **kw),
             "stats": lambda: ep.plain_stats(part, obs_rms, value_rms),
             "dataset": lambda: ep.plain_dataset(rec, adv, ret, consts)}
    bounds = prep_bound(rec.shape[1] - 13, rec.shape[2], rec.shape[0])
    for ph in ep.PHASES:
        times[f"prep_{ph}[{tag}]"] = (dev_ms[ph], cuda_time_ms(
            plain[ph], PLAIN_REPS), *bounds[ph])
    chain = cuda_time_ms(lambda: ep.epoch_prep(*case, **kw))
    plain_chain = cuda_time_ms(lambda: ep.epoch_prep_plain(*case, **kw),
                               PLAIN_REPS)
    print(f"[time] prep {tag}: " + ", ".join(
        f"{ph} {times[f'prep_{ph}[{tag}]'][0] * 1e3:.1f} us (plain "
        f"{times[f'prep_{ph}[{tag}]'][1]:.3f} ms, bound "
        f"{times[f'prep_{ph}[{tag}]'][2] * 1e3:.2f} us by bytes)"
        for ph in ep.PHASES) + f"; the chain {chain * 1e3:.1f} us between "
        f"CUDA events with its host work (plain {plain_chain:.3f} ms), "
        f"bound {sum(bounds[ph][0] for ph in ep.PHASES) * 1e3:.2f} us",
        flush=True)


def train_and_reload(runner_mod, ckpt, yaml_cfg, task, epochs, run_root,
                     probe_gen, kernels, num_envs=None, network_kw=None):
    """Train through the runner, its trainer built with ``network_kw``
    over the YAML's (as ``PPO(network_kw=...)``); save / reload the native
    checkpoint and the reference .pth. Returns (a trainer of the run's
    config, the run's TrainState, the run info)."""
    params = yaml_cfg["params"]
    params["config"]["max_epochs"] = epochs
    params["config"]["save_best_after"] = 1
    params["seed"] = 42
    runner = runner_mod.Runner().load(yaml_cfg)
    if network_kw:
        yaml_kw = runner.network_kw()
        runner.network_kw = lambda: {**yaml_kw, **network_kw}
    args = {"task": task, "ctl_mode": "rate", "device": "cuda",
            "run_root": run_root, "log_every": 1, "num_envs": num_envs}
    t0 = time.time()
    ts_run, info = runner.run_train(args)
    torch.cuda.synchronize()
    info["train_s"] = time.time() - t0
    # the launch counts of the run itself (reloading may launch again)
    info["launches"] = {k.name: dict(k.launches) for k in kernels}
    for row in info["history"]:
        print(f"[train {task}] epoch {row['epoch']}: mean_reward "
              f"{row['mean_reward']:.4f} loss {row['loss']:.5f} kl "
              f"{row['kl']:.3e} lr {row['lr']:.3e} epoch_s "
              f"{row['seconds']:.3f} fps {row['fps']:.0f}"
              + "".join(f" {k} {row[k]:.4f}" for k in ("success_rate",
                                                       "env_success_rate")
                        if k in row), flush=True)
        for key in ("mean_reward", "loss", "kl", "lr", "seconds"):
            check(math.isfinite(row[key]), f"{task} epoch {row['epoch']}: "
                                           f"{key} not finite")
    check(len(info["history"]) == epochs, f"{task}: missing epochs")

    _, trainer, _ = runner.build(args)
    ts_new = ckpt.restore(trainer.init(5), ckpt.load(info["checkpoint"]))
    for name, p in ts_run.model.state_dict().items():
        check(torch.equal(p, ts_new.model.state_dict()[name]),
              f"{task} checkpoint reload differs at {name}")
    check(torch.equal(ts_new.adam["count"], ts_run.adam["count"]),
          f"{task} checkpoint reload: Adam count differs")
    model2 = trainer.make_model()
    ckpt.import_pth(info["checkpoint"][:-3] + ".pth", model2)
    probe = torch.randn((64, trainer.task.num_obs), generator=probe_gen,
                        device="cuda")
    if trainer.obs_is_dict:
        cam = trainer.task.cam_cfg
        probe = {"observation": probe, "image": torch.rand(
            (64, 1, cam.width, cam.height), generator=probe_gen,
            device="cuda")}
    with torch.no_grad():
        mu_a, _, v_a = ts_run.model(probe)
        mu_b, _, v_b = model2(probe)
    check(torch.equal(mu_a, mu_b) and torch.equal(v_a, v_b),
          f"{task} .pth reload gives another mu / value")
    print(f"[train {task}] checkpoint {os.path.basename(info['checkpoint'])}"
          f" saved and reloaded (native + .pth)", flush=True)
    return trainer, ts_run, info


def profile_epoch(trainer, ts, tag, groups=None, forbid=(), expect=None):
    """One warm epoch, then one under torch.profiler: wall, device busy,
    the top kernels by device time. The profiler slows the host, so the
    busy time is also set against the warm epoch's own wall. Only device
    activity is traced: a vision epoch's millions of host op events took
    minutes to read back and are not used. Fails if a device event's name
    holds a word of ``forbid``, or if the events whose name holds a key of
    ``expect`` do not number its value."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ts_prof = trainer.train_epoch(ts)[0]               # warm
    torch.cuda.synchronize()
    warm_ms = 1e3 * (time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.train_epoch(ts_prof)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    # the device's own events (kernels, copies, memsets) only: a runtime
    # call's device time repeats the kernel it launched, and summing both
    # would count that time twice
    cpu = torch.autograd.DeviceType.CPU
    rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages()
                   if e.self_device_time_total > 0
                   and e.device_type != cpu), reverse=True)
    check(rows, f"profile {tag}: the profiler recorded no device events")
    print(f"[profile {tag}] closing and reading the profile took "
          f"{time.perf_counter() - t0 - wall_ms / 1e3:.1f} s", flush=True)
    busy_ms = sum(r[0] for r in rows)
    print(f"[profile {tag}] one epoch: wall {wall_ms:.2f} ms, device busy "
          f"{busy_ms:.2f} ms ({100 * busy_ms / wall_ms:.1f}%) under the "
          f"profiler, from {len(rows)} device event kinds; the warm epoch "
          f"unprofiled: wall {warm_ms:.2f} ms, so busy "
          f"{100 * busy_ms / warm_ms:.1f}% for the same device work",
          flush=True)
    if groups:
        by = {name: 0.0 for name in groups}
        by["the rest"] = 0.0
        for ms, _, key in rows:
            low = key.lower()
            hit = [name for name, words in groups.items()
                   if any(w in low for w in words)]
            by[hit[0] if hit else "the rest"] += ms
        print(f"[profile {tag}] device time by part: " + ", ".join(
            f"{name} {ms:.2f} ms ({100 * ms / busy_ms:.1f}%)"
            for name, ms in by.items()), flush=True)
    for ms, count, key in rows[:8]:
        print(f"[profile {tag}]   {ms:8.3f} ms  x{count:<5d} {key[:70]}",
              flush=True)
    for word, want in (expect or {}).items():
        got = sum(count for _, count, key in rows if word in key)
        print(f"[profile {tag}] {word}: {got} launch(es) in the epoch",
              flush=True)
        check(got == want, f"profile {tag}: {got} {word} launches in one "
                           f"epoch, expected {want}")
    banned = [key for _, _, key in rows
              if any(w in key.lower() for w in forbid)]
    check(not banned, f"profile {tag}: kernels that must not run: "
                      f"{[k[:70] for k in banned[:5]]}")


def cast_records(inp):
    """[N, 4] records each env's prepass keeps, by kind: the valid ones of
    the groups of 8 that start below the live count."""
    out, p = [], 0
    for k, cnt in enumerate(inp.counts):
        lim = torch.clamp((inp.live[:, k] + 7) // 8 * 8, max=cnt)
        idx = torch.arange(cnt, device=inp.prims.device)
        valid = inp.prims[:, p:p + cnt, 0] > 0.0
        out.append((valid & (idx[None] < lim[:, None])).sum(1))
        p += cnt
    return torch.stack(out, 1)


def render_ops(inp, process):
    """FP32 operations of one render (the counts above) on these inputs:
    the records this run's prepasses keep, the pixels, the blur's taps
    inside the image (render + process) and each env's ray tables."""
    n, W, H = inp.origins.shape[0], inp.cfg.width, inp.cfg.height
    kept = cast_records(inp).to(torch.float64).sum(0).tolist()
    per_pix = RAY_OPS + GROUND_OPS * int(inp.ground) + (
        PROCESS_PIXEL_OPS if process else DEPTH_OUT_OPS)
    ops = n * W * H * per_pix + n * (TABLE_OPS[0] * W + TABLE_OPS[1] * H)
    ops += sum(c * (W * H * k + q)
               for c, k, q in zip(kept, CAST_OPS, PREP_OPS))
    if process:
        ops += n * BLUR_TAP_OPS * (5 * W - 6) * (5 * H - 6)
    return ops


def render_bound(inp):
    """(bound ms, what bounds it, the parent design's bound ms) of one
    render + process: the operations above against the inputs read once
    and the image written once."""
    n = inp.origins.shape[0]
    pix = n * inp.cfg.width * inp.cfg.height
    nbytes = sum(x.numel() * x.element_size() for x in (
        inp.origins, inp.rots, inp.prims, inp.live, inp.taps))
    nbytes += 4 * n + 4 * pix                # seeds as uint32, the image
    live = inp.live.to(torch.float32).mean(0).tolist()
    old = pix * (OLD_PIXEL_OPS + sum(
        c * k for c, k in zip(live, OLD_RECORD_OPS)))
    return (*bound_ms(render_ops(inp, True), nbytes),
            bound_ms(old, nbytes)[0])


def render_vs_plain(rc, inp, tag):
    """Kernel vs plain on the same inputs: max error, pixels over
    RENDER_ATOL, and three checks. Each env's over-tolerance pixels fit in
    one 5 x 5 neighbourhood (one grazing ray flipped between hit and miss
    spreads through the blur to at most 5 x 5 pixels); at most
    max(1, N / 1000) envs hold such pixels at all; and no pixel is off by
    more than 1e-2 of the image maximum."""
    out_k = rc.render_process_packed(inp)
    out_p = rc.render_process_packed_plain(inp)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(out_k).all()), f"render {tag}: not finite")
    err = (out_k - out_p).abs()[:, 0]                       # [N, W, H]
    bad = err > RENDER_ATOL
    n_bad = int(bad.sum())
    envs_bad = torch.nonzero(bad.any(dim=2).any(dim=1))[:, 0].tolist()
    max_envs_bad = max(1, out_k.shape[0] // 1000)
    worst = 0
    for e in envs_bad[:max_envs_bad + 1]:
        u, v = torch.nonzero(bad[e], as_tuple=True)
        span = max(int(u.max() - u.min()), int(v.max() - v.min())) + 1
        worst = max(worst, span)
    live = inp.live.to(torch.float32).mean(0).tolist()
    print(f"[render {tag}] N={out_k.shape[0]} {inp.cfg.width}x"
          f"{inp.cfg.height} records {inp.prims.shape[1]} live per env "
          f"{[round(x, 3) for x in live]}: max|err| {float(err.max()):.3e} "
          f"pixels over {RENDER_ATOL:g}: {n_bad} in {len(envs_bad)} envs "
          f"(widest span {worst} px); image max {float(out_p.max()):.3f}",
          flush=True)
    check(worst <= 5, f"render {tag}: an env's pixels over tolerance span "
                      f"{worst} px, more than one 5x5 neighbourhood")
    check(len(envs_bad) <= max_envs_bad,
          f"render {tag}: {len(envs_bad)} envs hold pixels over tolerance, "
          f"more than {max_envs_bad}")
    img_max = float(out_p.max())
    check(float(err.max()) <= 1e-2 * img_max,
          f"render {tag}: max|err| {float(err.max()):.3e} exceeds 1e-2 of "
          f"the image max {img_max:.3f}")
    check(img_max > 0.0, f"render {tag}: blank images")
    return float(err.max()), live


def render_checks(ra, rc, dev):
    """Phase 12: the render kernel at Planning's full shape (guarded),
    on a box scene (unguarded) and on a scene of all four kinds
    (kernels/render_ab.process_cases). Returns (max error, the cases)."""
    cases = ra.process_cases(dev)
    inp = cases["planning 4096 guarded"]
    check(inp.prims.shape[1] == 48 and inp.counts == (40, 1, 0, 0),
          f"planning scene packs as {inp.counts} in {inp.prims.shape[1]}")
    inp_b = cases["box 1024 unguarded"]
    check(inp_b.prims.shape[1] == 8 and
          bool((inp_b.live == torch.tensor([0, 0, 1, 0], device=dev)).all()),
          "the box scene must run unguarded")
    errs = [render_vs_plain(rc, x, tag)[0] for tag, x in cases.items()]
    return max(errs), cases


def depth_bound(inp):
    """(bound ms, what bounds it, the parent design's bound ms) of one raw
    depth render: the operations above against the inputs read once and
    the [N, W, H] image written once."""
    n = inp.origins.shape[0]
    pix = n * inp.cfg.width * inp.cfg.height
    nbytes = sum(x.numel() * x.element_size() for x in (
        inp.origins, inp.rots, inp.prims, inp.live)) + 4 * pix
    live = inp.live.to(torch.float32).mean(0).tolist()
    old = pix * (OLD_RAY_OPS + sum(c * k for c, k in zip(live,
                                                         OLD_RECORD_OPS)))
    return (*bound_ms(render_ops(inp, False), nbytes),
            bound_ms(old, nbytes)[0])


def render_split(ra, clk, inp, tag):
    """Print where a block's cycles go on the clock build ``clk`` (one
    run): per env and as shares of the block's time."""
    launch = ra.LAUNCH[clk.name]
    stream = torch.cuda.current_stream().cuda_stream
    cyc = ra.phase_cycles(clk, lambda: launch(clk, inp, stream))
    check(cyc is not None and sum(cyc) > 0, f"{clk.name} {tag}: no clocks")
    print(f"[time] {clk.name} {tag}: a block's cycles per env: "
          f"{ra.split_line(clk, cyc, inp.origins.shape[0])}", flush=True)


def depth_vs_plain(rc, inp, tag):
    """The raw depth kernel vs its plain version on the same inputs:
    |err| <= DEPTH_ATOL where both hit, at most max(1, N / 1000) pixels
    where one side hits and the other misses. Returns (max error where
    both hit, live records per env)."""
    out_k = rc.render_depth_packed(inp)
    out_p = rc.render_depth_packed_plain(inp)
    torch.cuda.synchronize()
    n = inp.origins.shape[0]
    check(tuple(out_k.shape) == (n, inp.cfg.width, inp.cfg.height),
          f"depth {tag}: shape {tuple(out_k.shape)}")
    check(bool(torch.isfinite(out_k).all()), f"depth {tag}: not finite")
    hit_k, hit_p = out_k < DEPTH_HIT, out_p < DEPTH_HIT
    flips = int((hit_k != hit_p).sum())
    both = hit_k & hit_p
    err = float((out_k - out_p).abs()[both].max()) if bool(both.any()) \
        else 0.0
    n_diff = int((out_k != out_p).sum())
    live = inp.live.to(torch.float32).mean(0).tolist()
    print(f"[depth {tag}] N={n} {inp.cfg.width}x{inp.cfg.height} records "
          f"{inp.prims.shape[1]} live per env {[round(x, 3) for x in live]}: "
          f"max|err| where both hit {err:.3e}, hit / miss flips {flips}, "
          f"pixels not bit-equal {n_diff}, hit share "
          f"{float(both.float().mean()):.3f}", flush=True)
    check(err <= DEPTH_ATOL, f"depth {tag}: max|err| {err:.3e} > "
                             f"{DEPTH_ATOL:g}")
    check(flips <= max(1, n // 1000),
          f"depth {tag}: {flips} hit / miss flips > {max(1, n // 1000)}")
    check(float(both.float().mean()) > 0.05, f"depth {tag}: almost no hits")
    return err, live


def cnn_macs(h, w, folded=False):
    """Multiply-adds of one image through the conv stack: (forward,
    backward with its recompute; the backward adds each conv's weight
    gradient and, above conv0, its input gradient, and no image
    cotangent). By default the convolutions' own, which the function needs:
    conv0 5x5 1 -> 16 at the 2 x 2 outputs of each 4 x 4 cell, conv1 3x3
    16 -> 32 per cell, conv2 3x3 32 -> 64 per conv2 position. ``folded``
    counts the products the kernels execute instead, w0 [64, 64], w1
    [256, 32] and w2 [288, 64], structural zeros included."""
    hc, wc = h // 4, w // 4
    ho, wo = (hc + 1) // 2, (wc + 1) // 2
    if folded:
        c0, c1, c2 = hc * wc * 64 * 64, hc * wc * 256 * 32, ho * wo * 288 * 64
    else:
        c0, c1, c2 = (hc * wc * 4 * 16 * 25, hc * wc * 32 * 16 * 9,
                      ho * wo * 64 * 32 * 9)
    return c0 + c1 + c2, (c0 + c1 + c2) + 2 * c2 + 2 * c1 + c0


def cnn_bound(fc, x, backward, peak=None):
    """(bound ms, what bounds it) of one fused CNN call on these inputs:
    the convolutions' products (``cnn_macs``) at ``peak`` (by default the
    operands' own: bf16 tensor cores or FP32), the image and weights read
    once, the pooled output (forward) or the cotangent and the gradients
    (backward) moved once."""
    b, h, w = x.shape
    fwd, bwd = cnn_macs(h, w)
    flops = 2.0 * b * (bwd if backward else fwd)
    es = x.element_size()
    nbytes = b * h * w * es + fc.N_MAT * es + fc.N_ROWS * 4
    nbytes += (b * 64 + fc.N_PARAM) * 4 if backward else b * 64 * 4
    if peak is None:
        peak = PEAK_BF16 if x.dtype == torch.bfloat16 else PEAK_FP32
    return bound_ms(flops, nbytes, peak)


def cnn_inputs(fc, dev, b, dtype, seed):
    """Normalised-looking images [b, 212, 120] and the kernel inputs folded
    from a seeded CNNEncoder with non-trivial conv biases and batch norms,
    and a cotangent [b, 64]."""
    from airgym_tpu_torch.models.actor_critic import CNNEncoder
    g = torch.Generator(device=dev).manual_seed(seed)
    enc = CNNEncoder(compute_dtype=dtype, impl="pallas",
                     generator=torch.Generator().manual_seed(seed)).to(dev)
    with torch.no_grad():
        for i in (0, 3, 6):
            enc.features[i].bias.normal_(0.0, 0.1, generator=g)
        for i in (2, 5, 8):
            bn = enc.features[i]
            bn.running_mean.normal_(0.0, 0.3, generator=g)
            bn.running_var.uniform_(0.5, 2.0, generator=g)
            bn.weight.uniform_(0.5, 1.5, generator=g)
            bn.bias.normal_(0.0, 0.2, generator=g)
        w = enc.fused_weights()
        ws = [w[k].detach().to(dtype) if k in fc.MAT
              else w[k].detach().reshape(-1).float() for k in fc.W_KEYS]
    x = torch.randn((b, 212, 120), generator=g, device=dev).to(dtype)
    return x, ws, torch.randn((b, 64), generator=g, device=dev)


def cnn_vs_plain(fc, x, ws, dp, tag):
    """The fused CNN kernels vs their plain versions on the same inputs
    (the forward run twice, and the backward if ``dp`` is given: each pair
    bitwise equal). Returns (max |err| of the features, max |err| of the
    gradients)."""
    out_k, out_k2 = fc._fwd(x, ws), fc._fwd(x, ws)
    out_p = fc.encode_pooled_plain(x, ws)
    torch.cuda.synchronize()
    check(tuple(out_k.shape) == (x.shape[0], 64)
          and bool(torch.isfinite(out_k).all()), f"cnn {tag}: features")
    check(torch.equal(out_k, out_k2), f"cnn {tag}: two forward runs differ")
    scale = float(out_p.abs().max())
    err = float((out_k - out_p).abs().max())
    check(err <= CNN_FWD_TOL[x.dtype] * scale,
          f"cnn {tag}: forward max|err| {err:.3e} > "
          f"{CNN_FWD_TOL[x.dtype]:g} x {scale:.3e}")
    route = "mma.sync bf16 tensor cores" if x.dtype == torch.bfloat16 \
        else "scalar FP32"
    msg = f"[cnn {tag}] B={x.shape[0]} {x.dtype}: forward ({route}) " \
          f"max|err| {err:.3e} (max|ref| {scale:.3e}), two forward runs " \
          f"bitwise equal"
    if dp is None:
        print(msg, flush=True)
        return err, None
    g_k, g_k2 = fc._bwd(x, ws, dp), fc._bwd(x, ws, dp)
    g_p = fc.encode_pooled_plain_bwd(x, ws, dp)
    torch.cuda.synchronize()
    g_err, worst = 0.0, 0.0
    for key, a, a2, r in zip(fc.W_KEYS, g_k, g_k2, g_p):
        check(torch.equal(a, a2), f"cnn {tag}: two backward runs differ "
                                  f"at {key}")
        e, sc = float((a - r).abs().max()), float(r.abs().max())
        check(e <= CNN_BWD_TOL[x.dtype] * sc,
              f"cnn {tag}: gradient {key} max|err| {e:.3e} > "
              f"{CNN_BWD_TOL[x.dtype]:g} x {sc:.3e}")
        g_err, worst = max(g_err, e), max(worst, e / max(sc, 1e-30))
    print(f"{msg}; backward ({route}) gradients max|err| {g_err:.3e} (at "
          f"most {worst:.2e} of a tensor's max|ref|), two backward runs "
          f"bitwise equal", flush=True)
    return err, g_err


def cnn_checks(fc, dev):
    """Phase 20: the forward at B = 4096 in bf16 (the rollout's encodes),
    forward + backward at B = 609 in bf16 (a minibatch's unique frames)
    and at B = 64 in float32. Returns (errors, the inputs to time)."""
    x4, ws4, _ = cnn_inputs(fc, dev, 4096, torch.bfloat16, 41)
    e4, _ = cnn_vs_plain(fc, x4, ws4, None, "rollout 4096")
    x6, ws6, dp6 = cnn_inputs(fc, dev, 609, torch.bfloat16, 42)
    e6, g6 = cnn_vs_plain(fc, x6, ws6, dp6, "update 609")
    x64, ws64, dp64 = cnn_inputs(fc, dev, 64, torch.float32, 43)
    e64, g64 = cnn_vs_plain(fc, x64, ws64, dp64, "float32 64")
    return ((max(e4, e6, e64), max(g6, g64)),
            {"fwd": (x4, ws4), "bwd": (x6, ws6, dp6)})


def depth_checks(ra, rc, dev):
    """Phase 15: the raw depth kernel at MAPlanning's full shape (4096
    envs x 4 robots, after 30 env steps), at DepthGen's 1024-env scene of
    168 records (unguarded) and on a 256-env mixed scene culled at 4.5 m
    (kernels/render_ab.depth_cases). Returns (max error, {shape: inputs})."""
    cases = ra.depth_cases(dev)
    inp_ma = cases["maplanning 16384"]
    check(inp_ma.prims.shape == (16384, 8, 12) and inp_ma.counts
          == (0, 5, 0, 0), f"maplanning scene packs as {inp_ma.counts}")
    inp_dg = cases["depthgen 1024 unguarded"]
    check(inp_dg.prims.shape[1] == 168 and inp_dg.counts == (75, 72, 15, 3),
          f"depthgen scene packs as {inp_dg.counts}")
    inp_m = cases["mixed 256 guarded"]
    check(int(inp_m.live[:, 0].min()) < 20, "the mixed scene must be culled")
    errs = [depth_vs_plain(rc, x, tag)[0] for tag, x in cases.items()]
    return max(errs), {"maplanning": inp_ma, "depthgen": inp_dg}


@contextlib.contextmanager
def cwd(path):
    """Run the CLI from ``path``: its runs land in ``path/runs``."""
    os.makedirs(path, exist_ok=True)
    old = os.getcwd()
    os.chdir(path)
    try:
        yield
    finally:
        os.chdir(old)


def launched(kernels):
    """{kernel variant: launches} of every kernel, the zeros left out."""
    return {f"{k.name}/{v}": n for k in kernels
            for v, n in k.launches.items() if n}


def prep_launched(epochs):
    """launched()'s entries of the prep kernels in ``epochs`` fused
    epochs: one launch of each an epoch."""
    return {f"epoch_prep/{ph}": epochs for ph in ("gae", "stats", "dataset")}


def timed_cli(cli, argv):
    """cli.run_cli(argv) and its seconds up to a device sync."""
    t0 = time.time()
    out = cli.run_cli(argv)
    torch.cuda.synchronize()
    return out, time.time() - t0


def play_checks(out, tag, n_envs):
    check(out["games"] >= 1 and math.isfinite(out["mean_reward"]),
          f"{tag} play: {out}")
    print(f"[play {tag}] {n_envs} envs x {out['steps']} steps: games "
          f"{out['games']}, reward per game {out['mean_reward']:.4f}"
          + (f", success_rate {out['success_rate']:.4f}"
             if "success_rate" in out else ""), flush=True)


def train_hovering_to_the_end(cli, fr, fu, kernels, run_root):
    """Phase 23: the default Hovering run through the CLI to its YAML's
    end, beside the reference's curve, then played."""
    with open(os.path.join(CONVERGENCE, "hovering.json")) as f:
        ref = json.load(f)["reward_curve"]
    reset_counts(kernels)
    with cwd(run_root):
        (ts, info), train_s = timed_cli(cli, [
            "--train", "--task", "hovering", "--num_envs", "4096",
            "--seed", "42"])
        got = launched(kernels)
        epochs = info["epochs"]
        print(f"[train hovering 200] {epochs} epochs in {train_s:.2f} s "
              f"({ts.frame} frames); launches {got}", flush=True)
        check(got == {"fused_rollout/hovering": epochs,
                      "fused_update/obs18": epochs, **prep_launched(epochs)}
              and epochs == 200,
              f"hovering to the end: {epochs} epochs, launches {got}")
        hist = info["history"]
        check(len(hist) == len(ref) == 50,
              f"hovering: {len(hist)} logged points, the reference "
              f"{len(ref)}")
        for row in hist:
            check(all(math.isfinite(row[k]) for k in ("mean_reward", "loss",
                                                      "kl", "lr")),
                  f"hovering epoch {row['epoch']}: not finite: {row}")
        for i in (0, 9, 24, len(hist) - 1):
            print(f"[train hovering 200] logged point {i + 1}: frame "
                  f"{hist[i]['frames']} mean_reward "
                  f"{hist[i]['mean_reward']:.3f}; the reference at frame "
                  f"{ref[i][0]}: {ref[i][1]}", flush=True)
        with open(os.path.join(info["run_dir"], "events.jsonl")) as f:
            tags = {json.loads(line)["tag"] for line in f}
        check({"rewards/frame", "losses/a_loss"} <= tags
              and any(t.startswith("Episode/") for t in tags),
              f"hovering events.jsonl tags: {sorted(tags)}")
        print(f"[train hovering 200] events.jsonl: {len(tags)} tags, "
              f"{sorted(t for t in tags if t.startswith('Episode/'))}",
              flush=True)
        pth = info["checkpoint"][:-3] + ".pth"
        check(os.path.basename(pth) == "last_ppo_hovering.pth", pth)
        reset_counts(kernels)
        out, play_s = timed_cli(cli, [
            "--play", "--task", "hovering", "--num_envs", "4096",
            "--checkpoint", pth, "--max_steps", str(HOVER_PLAY_STEPS)])
    check(not launched(kernels), f"hovering play launched "
                                 f"{launched(kernels)}")
    play_checks(out, "hovering", 4096)
    print(f"[play hovering] {4096 * out['steps'] / play_s:.0f} env-steps/s "
          f"({play_s:.2f} s with set-up and restore)", flush=True)


def train_and_eval_balloon(cli, runner_mod, fr, fu, kernels, run_root,
                           b_yaml):
    """Phase 24: Balloon's 200 epochs with the fused trainer, evaluated at
    the reference eval's shape."""
    with open(os.path.join(CONVERGENCE, "balloon_eval.json")) as f:
        ref = json.load(f)
    reset_counts(kernels)
    t0 = time.time()
    _, info = runner_mod.Runner().load(b_yaml).run_train(
        {"task": "balloon", "ctl_mode": "rate", "device": "cuda",
         "run_root": run_root, "num_envs": 4096, "seed": 42})
    torch.cuda.synchronize()
    got = launched(kernels)
    epochs = info["epochs"]
    hist = info["history"]
    print(f"[train balloon 200] {epochs} epochs in {time.time() - t0:.2f} s;"
          f" launches {got}; success_rate at logged points 1 / 10 / 25 / "
          f"last: " + ", ".join(f"{hist[i]['success_rate']:.4f}"
                                for i in (0, 9, 24, len(hist) - 1)),
          flush=True)
    check(epochs == 200 and got == {"fused_rollout/balloon": epochs,
                                    "fused_update/obs18": epochs,
                                    **prep_launched(epochs)},
          f"balloon: {epochs} epochs, launches {got}")
    check(all(math.isfinite(r["mean_reward"]) for r in hist),
          "balloon: a reward is not finite")
    reset_counts(kernels)
    with cwd(run_root):
        out, play_s = timed_cli(cli, [
            "--play", "--task", "balloon", "--num_envs",
            str(ref["num_envs"]), "--max_steps", str(ref["steps"]),
            "--seed", str(ref["seed"]),
            "--checkpoint", info["checkpoint"][:-3] + ".pth"])
    check(not launched(kernels), f"balloon play launched "
                                 f"{launched(kernels)}")
    play_checks(out, "balloon", ref["num_envs"])
    rate = ref["num_envs"] * out["steps"] / play_s
    print(f"[play balloon] success_rate {out['success_rate']:.4f} over "
          f"{out['games']} games; the reference's eval {ref['success_rate']}"
          f" over {ref['games']} games; {rate:.0f} env-steps/s "
          f"({play_s:.2f} s with set-up)", flush=True)
    check(out["success_rate"] >= BALLOON_SUCCESS_MIN
          and out["games"] >= BALLOON_GAMES_MIN,
          f"balloon eval: success {out['success_rate']:.4f} over "
          f"{out['games']} games, need >= {BALLOON_SUCCESS_MIN} over >= "
          f"{BALLOON_GAMES_MIN}")


def play_planning(cli, rc, kernels, run_root, p_pth, horizon):
    """Phase 25: the Planning checkpoint played through B6."""
    from airgym_tpu_torch.envs.planning import PlanningCfg
    with open(os.path.join(CONVERGENCE, "planning_eval.json")) as f:
        ref = json.load(f)
    check(ref["num_envs"] == PLANNING_PLAY_ENVS, "planning_eval.json envs")
    ce = PlanningCfg().cam_every
    # the env renders on every step whose counter is a multiple of
    # cam_every: the Player's trainer.init steps the counter to cam_every
    # (frame dedup aligns it when cam_every divides the horizon: one
    # render), then the Player boots a fresh batch (counter 1) and plays
    # counters 2 .. 1 + steps
    want_init = 1 if horizon % ce == 0 else 0
    want_play = (1 + PLANNING_PLAY_STEPS) // ce
    reset_counts(kernels)
    with cwd(run_root):
        out, play_s = timed_cli(cli, [
            "--play", "--task", "planning", "--num_envs",
            str(PLANNING_PLAY_ENVS), "--seed", str(ref["seed"]),
            "--max_steps", str(PLANNING_PLAY_STEPS), "--checkpoint", p_pth])
    got = launched(kernels)
    n = rc.KERNEL.launches.get("render_process", 0)
    print(f"[play planning] render_process launches {n} (the cadence: "
          f"{want_init} in the Player's trainer.init + {want_play} in "
          f"{PLANNING_PLAY_STEPS} steps at cam_every {ce}); all launches "
          f"{got}", flush=True)
    check(got == {"render_process/render_process": want_init + want_play},
          f"planning play launches {got}, expected "
          f"{want_init + want_play} render_process")
    play_checks(out, "planning", PLANNING_PLAY_ENVS)
    print(f"[play planning] {PLANNING_PLAY_ENVS * out['steps'] / play_s:.0f}"
          f" env-steps/s ({play_s:.2f} s with set-up and restore)",
          flush=True)
    return n


def play_control_modes(cli, runner_mod, kernels, run_root, h_yaml):
    """Phase 26: Hovering in pos / vel / atti / prop, then trained and
    played in vel through the CLI."""
    from airgym_tpu_torch.rl import ppo as ppo_mod
    for mode in ("pos", "vel", "atti", "prop"):
        reset_counts(kernels)
        task, trainer, _ = runner_mod.Runner().load(h_yaml).build(
            {"task": "hovering", "ctl_mode": mode, "num_envs": 4096,
             "device": "cuda", "seed": 1})
        check(type(trainer) is ppo_mod.PPO,
              f"{mode}: the runner picked {type(trainer).__name__}")
        player = runner_mod.Player(task, trainer)
        n_act = player.ts.model.mu.out_features
        check(n_act == (5 if mode == "atti" else 4),
              f"{mode}: the policy has {n_act} outputs")
        t0 = time.time()
        out = player.run(max_steps=MODE_PLAY_STEPS, chunk=MODE_PLAY_STEPS)
        dt = time.time() - t0
        check(not launched(kernels), f"{mode} play launched "
                                     f"{launched(kernels)}")
        play_checks(out, f"hovering {mode}", 4096)
        print(f"[play hovering {mode}] {n_act} actions; "
              f"{4096 * out['steps'] / dt:.0f} env-steps/s", flush=True)
    cfg = json.loads(json.dumps(h_yaml))
    cfg["params"]["config"].update(max_epochs=MODE_TRAIN_EPOCHS,
                                   save_best_after=1)
    path = os.path.join(run_root, "ppo_hovering_vel.yaml")
    with open(path, "w") as f:
        json.dump(cfg, f)            # JSON is YAML
    reset_counts(kernels)
    with cwd(run_root):
        (ts, info), train_s = timed_cli(cli, [
            "--train", "--task", "hovering", "--ctl_mode", "vel", "--file",
            path, "--num_envs", "4096", "--seed", "42"])
        for row in info["history"]:
            check(all(math.isfinite(row[k]) for k in ("mean_reward", "loss",
                                                      "kl", "lr")),
                  f"hovering vel epoch {row['epoch']}: {row}")
            print(f"[train hovering vel] epoch {row['epoch']}: mean_reward "
                  f"{row['mean_reward']:.4f} loss {row['loss']:.5f} kl "
                  f"{row['kl']:.3e} epoch_s {row['seconds']:.3f}",
                  flush=True)
        check(info["epochs"] == MODE_TRAIN_EPOCHS
              and float(ts.adam["count"][0]) > 0,
              f"hovering vel: {info['epochs']} epochs")
        out, _ = timed_cli(cli, [
            "--play", "--task", "hovering", "--ctl_mode", "vel", "--file",
            path, "--num_envs", "4096", "--max_steps", str(MODE_PLAY_STEPS),
            "--checkpoint", info["checkpoint"][:-3] + ".pth"])
    check(not launched(kernels), f"hovering vel train / play launched "
                                 f"{launched(kernels)}")
    print(f"[train hovering vel] {MODE_TRAIN_EPOCHS} epochs with the plain "
          f"trainer in {train_s:.2f} s, no kernel launched", flush=True)
    play_checks(out, "hovering vel (trained)", 4096)


def epoch_ms(info):
    return [round(1e3 * row["seconds"], 1) for row in info["history"]]


def train_model_options(cli, kernels, run_root, h_yaml, card):
    """Phase 27: Hovering with separate: True, fixed_sigma: False and
    activation tanh through the CLI (the plain trainer), its .pth keys,
    then played."""
    cfg = json.loads(json.dumps(h_yaml))
    net = cfg["params"]["network"]
    net["separate"] = True
    net["space"]["continuous"]["fixed_sigma"] = False
    net["mlp"]["activation"] = "tanh"
    cfg["params"]["config"].update(max_epochs=OPTION_EPOCHS,
                                   save_best_after=1)
    path = os.path.join(run_root, "ppo_hovering_options.yaml")
    with open(path, "w") as f:
        json.dump(cfg, f)            # JSON is YAML
    reset_counts(kernels)
    with cwd(run_root):
        (ts, info), train_s = timed_cli(cli, [
            "--train", "--task", "hovering", "--file", path, "--num_envs",
            "4096", "--seed", "42"])
        got = launched(kernels)
        model = ts.model
        check(info["epochs"] == OPTION_EPOCHS and not got
              and hasattr(model, "critic_mlp")
              and isinstance(model.logstd, torch.nn.Linear)
              and model.activation == "tanh",
              f"hovering options: {info['epochs']} epochs, launches {got}")
        for row in info["history"]:
            check(all(math.isfinite(row[k]) for k in ("mean_reward", "loss",
                                                      "kl", "lr")),
                  f"hovering options epoch {row['epoch']}: {row}")
        pth = info["checkpoint"][:-3] + ".pth"
        keys = set(torch.load(pth, map_location="cpu",
                              weights_only=True)["model"])
        check("critic_mlp.layers.0.weight" in keys
              and {"logstd.weight", "logstd.bias"} <= keys
              and "logstd" not in keys,
              f"hovering options .pth keys: {sorted(keys)}")
        out, play_s = timed_cli(cli, [
            "--play", "--task", "hovering", "--file", path, "--num_envs",
            "4096", "--max_steps", str(OPTION_PLAY_STEPS), "--checkpoint",
            pth])
    check(not launched(kernels), f"hovering options play launched "
                                 f"{launched(kernels)}")
    play_checks(out, "hovering options", 4096)
    print(f"[train hovering options] separate, state sigma, tanh: "
          f"{OPTION_EPOCHS} epochs x 4096 x "
          f"{cfg['params']['config']['horizon_length']} with the plain "
          f"trainer in {train_s:.2f} s, ms per epoch {epoch_ms(info)}, no "
          f"kernel launched; .pth has critic_mlp.* and logstd.weight / "
          f".bias, no logstd; played {OPTION_PLAY_STEPS} steps in "
          f"{play_s:.2f} s; card {card}", flush=True)


def write_pretrained(enc, folder):
    """Phases 28-29: the pretrained file a user would supply, written
    here from a seed: a torch VAE state dict with keys prefixed 'module.'
    and 'dronet.' (clean_state_dict's renames), or a torchvision-layout
    resnet18 (3-channel conv1, BatchNorm2d statistics, a 1000-way fc)."""
    g = torch.Generator().manual_seed(29)
    if enc == "vae":
        from airgym_tpu_torch.models.vae import VAE
        sd = {("module." + k.replace("encoder.", "dronet.", 1)): v
              for k, v in VAE(64, generator=g).state_dict().items()}
        name = "vae_model.pth"
    else:
        from airgym_tpu_torch.models.resnet import ResNet18Encoder
        sd = {}
        for k, v in ResNet18Encoder(1000, generator=g).state_dict().items():
            if k == "conv1.weight":
                v = torch.randn((64, 3, 7, 7), generator=g) * 0.05
            elif k.endswith("running_mean"):
                v = torch.randn(v.shape, generator=g) * 0.1
            elif k.endswith("running_var"):
                v = torch.rand(v.shape, generator=g) + 0.5
            elif ".bn" in k or "downsample.1" in k or k.startswith("bn1"):
                v = (torch.rand(v.shape, generator=g) + 0.5
                     if v.is_floating_point() else v)
            sd[k] = v
        name = "resnet18.pth"
    torch.save(sd, os.path.join(folder, name))
    return name


def train_planning_encoder(runner_mod, ckpt, rc, kernels, run_root, p_yaml,
                           enc, card):
    """Phases 28 (vae) and 29 (resnet): Planning at its YAML's 4096 envs
    with a pretrained encoder block in place of the CNN, one epoch through
    the runner; the grafted frozen weights equal the file's after it."""
    from airgym_tpu_torch.envs.planning import PlanningCfg
    from airgym_tpu_torch.models import resnet as resnet_mod
    from airgym_tpu_torch.models import vae as vae_mod
    cfg = json.loads(json.dumps(p_yaml))
    net = cfg["params"]["network"]
    del net["cnn"]
    folder = os.path.join(run_root, f"pretrained_{enc}")
    os.makedirs(folder, exist_ok=True)
    name = write_pretrained(enc, folder)
    net[enc] = ({"latent_dims": 64} if enc == "vae"
                else {"type": "resnet18", "output_dim": 30})
    net[enc].update(model_folder=folder, model_file=name)
    cfg["params"]["config"].update(max_epochs=1, save_best_after=1)
    runner = runner_mod.Runner().load(cfg)
    args = {"task": "planning", "ctl_mode": "rate", "device": "cuda",
            "run_root": run_root, "num_envs": 4096, "seed": 42}
    file_sd = torch.load(os.path.join(folder, name), map_location="cpu",
                         weights_only=True)
    if enc == "vae":
        want = {k[len("encoder."):]: v for k, v in
                vae_mod.import_torch_state_dict(file_sd).items()
                if k.startswith("encoder.")}
        part = lambda m: m.actor_enc.encoder.state_dict()
    else:
        want = {k: v for k, v in resnet_mod.import_torchvision_state_dict(
            file_sd, 30).items() if not k.startswith("fc.")}
        part = lambda m: {k: v for k, v in m.actor_resnet.state_dict()
                          .items() if not k.startswith("fc.")}

    def same(sd):
        return all(torch.equal(sd[k].cpu(), v) for k, v in want.items())

    # the graft on the state the run starts from (the same seed)
    _, trainer, _ = runner.build(args)
    ts0 = runner._maybe_load_pretrained_vae(trainer.init(42))
    check(same(part(ts0.model)), f"planning {enc}: the graft differs from "
                                 f"the file")
    fc0 = (ts0.model.actor_resnet.fc.weight.detach().clone()
           if enc == "resnet" else None)
    del trainer, ts0
    torch.cuda.empty_cache()
    reset_counts(kernels)
    torch.cuda.reset_peak_memory_stats()
    ts, info = runner.run_train(args)
    torch.cuda.synchronize()
    got = launched(kernels)
    peak = torch.cuda.max_memory_allocated() / 1e9
    hc = int(cfg["params"]["config"]["horizon_length"])
    want_renders = 1 + hc // PlanningCfg().cam_every
    check(got == {"render_process/render_process": want_renders},
          f"planning {enc}: launches {got}, expected {want_renders} "
          f"render_process")
    check(same(part(ts.model)), f"planning {enc}: the frozen encoder "
                                f"changed in the epoch")
    if enc == "resnet":
        check(not torch.equal(ts.model.actor_resnet.fc.weight, fc0),
              "planning resnet: fc did not train")
    row = info["history"][-1]
    bad = [k for k, v in row.items() if not math.isfinite(v)]
    check(info["epochs"] == 1 and not bad,
          f"planning {enc}: {info['epochs']} epochs, not finite {bad}")
    pth_keys = set(torch.load(info["checkpoint"][:-3] + ".pth",
                              map_location="cpu",
                              weights_only=True)["model"])
    enc_mod = "actor_enc" if enc == "vae" else "actor_resnet"
    check(not any(k.startswith(enc_mod) for k in pth_keys)
          and any(k.startswith(enc_mod) for k in
                  ckpt.load(info["checkpoint"])["model"]),
          f"planning {enc}: the .pth must leave the encoder out, the "
          f"native checkpoint carry it")
    print(f"[train planning {enc}] 1 epoch x 4096 x {hc} (pretrained file "
          f"{name} grafted, equal to the file before and after the epoch"
          + (", fc trained" if enc == "resnet" else "") + f"): ms per epoch "
          f"{epoch_ms(info)}; launches {got}; peak device memory "
          f"{peak:.2f} GB; mean_reward {row['mean_reward']:.4f} loss "
          f"{row['loss']:.5f}; card {card}", flush=True)
    return got["render_process/render_process"]


def warm_start_maplanning(runner_mod, ckpt, rc, kernels, run_root, m_yaml,
                          card):
    """Phase 30: MAPlanning for 1 epoch at 2 robots, then the
    robot-count warm start into its YAML's 4 robots for 1 epoch."""
    from airgym_tpu_torch.envs.maplanning import MAPlanningCfg
    ce = MAPlanningCfg().cam_every
    cfgs = {}
    for r in (2, 4):
        cfg = json.loads(json.dumps(m_yaml))
        cfg["params"]["config"].update(max_epochs=1, save_best_after=1)
        cfg["params"]["config"]["env_config"] = {"use_image": True,
                                                 "num_robots": r}
        cfgs[r] = cfg
    args = {"task": "maplanning", "ctl_mode": "rate", "device": "cuda",
            "run_root": run_root, "num_envs": 4096, "seed": 42}
    hc = int(m_yaml["params"]["config"]["horizon_length"])
    renders = {}
    reset_counts(kernels)
    t0 = time.time()
    ts2, info2 = runner_mod.Runner().load(cfgs[2]).run_train(args)
    torch.cuda.synchronize()
    renders[2] = (launched(kernels), time.time() - t0, epoch_ms(info2))
    src = ckpt.load(info2["checkpoint"])

    # the transferred policy before its epoch against the source's
    runner4 = runner_mod.Runner().load(cfgs[4])
    task4, trainer4, _ = runner4.build(args)
    check(task4.num_obs == 24 and ts2.model.actor_mlp.layers[0]
          .in_features == 20 + 30, "maplanning widths")
    ts4 = ckpt.transfer_obs_width(trainer4, trainer4.init(42), src, 20, 24)
    g = torch.Generator(device="cuda").manual_seed(30)
    cam = task4.cam_cfg
    vec = torch.randn((256, 16), generator=g, device="cuda")
    img = torch.rand((256, 1, cam.width, cam.height), generator=g,
                     device="cuda")
    pad = lambda r: {"image": img, "observation": torch.cat(
        [vec, torch.zeros((256, 2 * r), device="cuda")], -1)}
    errs = []
    with torch.no_grad():
        for a, b in zip(ts2.model(pad(2), ts2.obs_rms),
                        ts4.model(pad(4), ts4.obs_rms)):
            err = float((a - b).abs().max()) / max(float(a.abs().max()),
                                                   1e-30)
            errs.append(err)
    check(max(errs) <= TRANSFER_RTOL,
          f"maplanning warm start: mu / sigma / value differ by {errs} of "
          f"max|ref|")
    del trainer4, ts4, task4
    torch.cuda.empty_cache()

    reset_counts(kernels)
    t0 = time.time()
    ts4, info4 = runner4.run_train({
        **args, "transfer_checkpoint": info2["checkpoint"],
        "transfer_old_obs_dim": 20})
    torch.cuda.synchronize()
    renders[4] = (launched(kernels), time.time() - t0, epoch_ms(info4))
    for r, (got, secs, ms) in renders.items():
        check(got == {"render_depth/render_depth": 1 + hc // ce},
              f"maplanning {r} robots: launches {got}, expected "
              f"{1 + hc // ce} render_depth")
        print(f"[warm start maplanning] {r} robots x 4096 envs: 1 epoch, "
              f"ms per epoch {ms}, {secs:.2f} s with set-up; launches "
              f"{got}; card {card}", flush=True)
    row = info4["history"][-1]
    check(info4["epochs"] == 1 and ts4.epoch == 1
          and math.isfinite(row["mean_reward"])
          and ts4.model.actor_mlp.layers[0].in_features == 24 + 30,
          f"maplanning warm start: {info4['epochs']} epochs, {row}")
    print(f"[warm start maplanning] 2 -> 4 robots: mu / sigma / value on "
          f"zero-padded robot channels within {[f'{e:.2e}' for e in errs]}"
          f" of max|ref| (limit {TRANSFER_RTOL}); after the epoch "
          f"mean_reward {row['mean_reward']:.4f} env_success_rate "
          f"{row['env_success_rate']:.4f}", flush=True)
    return (renders[2][0]["render_depth/render_depth"]
            + renders[4][0]["render_depth/render_depth"])


def scene_rows(scene, k):
    """The first ``k`` envs of a SceneForRender."""
    return type(scene)(*[type(p)(*[t[:k] for t in p])
                         if isinstance(p, tuple) else p for p in scene])


def scene_tensors(state):
    """Every per-env tensor of a Customized state's scene and asset
    states."""
    return [t for p in state.scene if isinstance(p, tuple)
            for t in p] + [state.asset_states]


def train_customized(runner_mod, envs, rc, kernels, run_root, p_yaml,
                     height, card):
    """Phases 31 (212 x 120) and 32 (212 x 240): Customized at the
    Planning YAML's 4096 envs for 1 epoch through the runner. Returns the
    image moments of the run's last state and the launches."""
    cfg = json.loads(json.dumps(p_yaml))
    c = cfg["params"]["config"]
    c.update(env_name="customized", name="ppo_customized", max_epochs=1,
             save_best_after=1, num_actors=CUSTOM_ENVS)
    c["env_config"] = {} if height == 120 else {"cam_height": height}
    tall = height > rc.LANES - 2
    tag = f"customized 212x{height}"
    args = {"task": "customized", "ctl_mode": "rate", "device": "cuda",
            "run_root": run_root, "seed": 42}
    torch.cuda.empty_cache()
    reset_counts(kernels)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    ts, info = runner_mod.Runner().load(cfg).run_train(args)
    torch.cuda.synchronize()
    secs = time.time() - t0
    got = launched(kernels)
    peak = torch.cuda.max_memory_allocated() / 1e9
    task = envs.make_task("customized", num_envs=CUSTOM_ENVS, device="cuda",
                          **c["env_config"])
    renders = 1 + int(c["horizon_length"]) // task.cam_every
    want = {("render_depth/render_depth" if tall
             else "render_process/render_process"): renders}
    check(got == want, f"{tag}: launches {got}, expected {want}")
    row = info["history"][-1]
    bad = [k for k, v in row.items() if not math.isfinite(v)]
    check(info["epochs"] == 1 and not bad, f"{tag}: {info['epochs']} "
                                           f"epochs, not finite {bad}")
    state = ts.env_state
    cam = state.camera
    check(tuple(cam.shape) == (CUSTOM_ENVS, 1, 212, height)
          and bool(torch.isfinite(cam).all()), f"{tag}: camera "
                                               f"{tuple(cam.shape)}")
    moments = (float(cam.mean()), float(cam.std()))

    # the kernel against its plain version on 8 envs of the last state
    k = 8
    root, scene = state.core.root[:k], scene_rows(state.scene, k)
    if tall:
        inp = rc.prepare(task.cam_cfg, root, scene, None,
                         task.cam_cfg.depth_clamp)
        err, _ = depth_vs_plain(rc, inp, tag)
        lanes = rc._pixel_lanes(212, height, torch.device("cuda"))
        check(int(lanes.unique().numel()) == 212 * height,
              f"{tag}: two pixels share a hash index")
    else:
        inp = rc.prepare(task.cam_cfg, root, scene, 1234,
                         task.cam_cfg.depth_clamp)
        err, _ = render_vs_plain(rc, inp, tag)

    # a forced reset of env 0: every other env's scene keeps its bits
    prog = state.core.progress.clone()
    prog[0] = task.cfg.max_episode_length - 2
    s = state._replace(core=state.core._replace(progress=prog))
    gen = torch.Generator(device="cuda").manual_seed(31)
    s2, out = task.step(s, torch.zeros((CUSTOM_ENVS, 4), device="cuda"),
                        gen, render=False)
    keep = ~out.reset
    same = all(torch.equal(a[keep], b[keep])
               for a, b in zip(scene_tensors(state), scene_tensors(s2)))
    moved = not torch.equal(state.scene.cylinders.center[0],
                            s2.scene.cylinders.center[0])
    check(bool(out.reset[0]) and same and moved,
          f"{tag}: forced reset of env 0: reset {bool(out.reset[0])}, "
          f"others unchanged {same}, env 0 drawn anew {moved}")
    print(f"[train {tag}] 1 epoch x {CUSTOM_ENVS} x "
          f"{c['horizon_length']} through the runner in {secs:.2f} s, ms "
          f"per epoch {epoch_ms(info)}; launches {got}; peak device memory "
          f"{peak:.2f} GB; kernel vs plain on {k} envs {err:.3e}; a forced "
          f"reset of env 0 redrew its scene and left the other "
          f"{int(keep.sum())} envs' scenes bitwise unchanged; image mean "
          f"{moments[0]:.4f} std {moments[1]:.4f}; card {card}",
          flush=True)
    return moments, got


def flat_params(ts):
    return torch.cat([p.detach().reshape(-1).cpu()
                      for p in ts.model.parameters()]).numpy()


def epoch_params(run_dir, name, epoch):
    """The model's floating tensors in the run's checkpoint of ``epoch``,
    flattened in state-dict order."""
    from airgym_tpu_torch.rl import checkpoint as ckpt
    sd = ckpt.load(os.path.join(run_dir, "nn",
                                f"last_{name}_ep_{epoch}.pt"))["model"]
    return torch.cat([v.reshape(-1).float() for v in sd.values()
                      if v.is_floating_point()]).numpy()


def multi_gpu(runner_mod, run_root, h_yaml, p_yaml, card):
    """Phase 33: parallel/dist.dryrun of Hovering (2 epochs) and Planning
    (1 epoch) at their YAMLs' 4096 envs on two ranks, each held to two
    one-process runs of the same seed:

    * its witness (``shares=2``: every minibatch in the two ranks'
      shares, their gradients added in rank order, as the two ranks'
      all-reduce adds them): every epoch's metrics and the parameters,
      bit for bit. This holds the distributed update on the card: the
      ranks' frame windows, the gradient all-reduce, the clip, the KL and
      the adaptive learning rate;
    * the plain one-process run (``shares=1``, whole minibatches):
      within tests/test_multichip.py's tolerances before Adam carries the
      order of the sums into the weights (Hovering's first epoch and its
      checkpoint, Planning's rollout metrics, ROLLOUT_METRICS). Past that
      point the ranks' and the witness's distances from the plain run
      are printed side by side: equal distances say that the order of the
      sums is all that separates the ranks from one process.

    Then one rank over NCCL against the one-process Hovering epoch (the
    fused update), bit for bit."""
    from airgym_tpu_torch.envs.planning import PlanningCfg
    from airgym_tpu_torch.parallel import dist as pdist
    backend = "nccl" if torch.cuda.device_count() >= 2 else "gloo"
    args = {"ctl_mode": "rate", "device": "cuda", "seed": 42}
    strip = lambda h: [{k: v for k, v in row.items()
                        if k not in ("seconds", "fps")} for row in h]

    def cfg_of(yaml_cfg, epochs):
        cfg = json.loads(json.dumps(yaml_cfg))
        cfg["params"]["config"].update(max_epochs=epochs, save_best_after=1,
                                       save_frequency=1)
        return cfg

    def one_process(cfg, task, tag, shares=None):
        ts, info = runner_mod.Runner().load(cfg).run_train(
            {**args, "task": task, "shares": shares,
             "run_root": os.path.join(run_root, f"one_{tag}")})
        torch.cuda.synchronize()
        return flat_params(ts), info["history"], info["run_dir"]

    def ranks(world, be, cfg, task, tag, plain, tol, epochs_held,
              keys=None, witness=None):
        """dryrun; the whole run against ``witness``, bit for bit; the
        first ``epochs_held`` epochs' metrics (those of ``keys``, or all)
        and the parameters after them against the plain run."""
        torch.cuda.empty_cache()
        root = os.path.join(run_root, f"ranks_{tag}_{be}_{world}")
        shutil.rmtree(root, ignore_errors=True)
        t0 = time.time()
        reports = pdist.dryrun(world, cfg, {**args, "task": task,
                                            "run_root": root}, be)
        secs = time.time() - t0
        hist, ref_hist = reports[0]["history"], plain[1]
        p_end = reports[0]["params"]
        name = cfg["params"]["config"]["name"]
        p_held = epoch_params(reports[0]["run_dir"], name, epochs_held)
        ref_held = epoch_params(plain[2], name, epochs_held)
        held_err = float(np.max(np.abs(p_held - ref_held)))
        rtol, atol, param_atol = tol
        bad = pdist.compare_history(hist[:epochs_held],
                                    ref_hist[:epochs_held], rtol, atol,
                                    **({"keys": keys} if keys else {}))
        check(not bad and (param_atol is None or held_err <= param_atol),
              f"multi-gpu {tag}: against the plain one-process run after "
              f"epoch {epochs_held}: parameters {held_err:.3e} apart (limit "
              f"{param_atol}), metrics beyond rtol {rtol} / atol {atol}: "
              f"{bad}")
        gap = lambda p: float(np.max(np.abs(p - plain[0])))
        seen = ""
        if witness is not None:
            w_bad = pdist.compare_history(hist, witness[1], 0.0, 0.0)
            w_err = float(np.max(np.abs(p_end - witness[0])))
            check(not w_bad and w_err == 0.0,
                  f"multi-gpu {tag}: the ranks against their one-process "
                  f"witness (shares={world}): parameters {w_err:.3e} "
                  f"apart, metrics not bit-equal: {w_bad}")
            w_rows = "; ".join(
                f"epoch {a['epoch']}: loss {a['loss']:.6f}, kl "
                f"{a['kl']:.4e}, clip_frac {a['clip_frac']:.4f}"
                for a in witness[1])
            seen = (f"; bit for bit the witness (shares={world}) in every "
                    f"epoch ({w_rows}); distance from the plain run at the "
                    f"end: ranks {gap(p_end):.3e}, witness "
                    f"{gap(witness[0]):.3e}")
        for r in reports:
            print(f"[multi-gpu {tag}] backend {r['backend']} world "
                  f"{r['world']} rank {r['rank']}: launches "
                  f"{r['launches']}, torch seed {r['torch_seed']}, "
                  f"wrote {'the run' if r['checkpoint'] else 'nothing'}",
                  flush=True)
        rows = "; ".join(
            f"epoch {a['epoch']}: mean_reward {a['mean_reward']:.6f} / "
            f"{b['mean_reward']:.6f}, loss {a['loss']:.6f} / "
            f"{b['loss']:.6f}, kl {a['kl']:.4e} / {b['kl']:.4e}, clip_frac "
            f"{a['clip_frac']:.4f} / {b['clip_frac']:.4f}, lr "
            f"{a['lr']:.3e}" for a, b in zip(hist, ref_hist))
        ms = lambda h: [round(1e3 * x["seconds"], 1) for x in h]
        print(f"[multi-gpu {tag}] backend {be} world {world}: {len(hist)} "
              f"epochs in {secs:.2f} s with the ranks' start-up, ms per "
              f"epoch {ms(hist)} (one process {ms(ref_hist)}); ranks "
              f"bitwise equal; against the plain one-process run "
              f"(ranks / one process): {rows}; parameters "
              f"{held_err:.3e} apart after epoch {epochs_held} (held to "
              f"{tol}: metrics rtol, atol, parameters atol), "
              f"{gap(p_end):.3e} at the end{seen}; card {card}", flush=True)
        return reports, strip(hist) == strip(ref_hist) and np.array_equal(
            p_end, plain[0])

    h_cfg = cfg_of(h_yaml, 2)
    plain = one_process(h_cfg, "hovering", "hovering", shares=1)
    witness = one_process(h_cfg, "hovering", "hovering_w2", shares=2)
    reports, _ = ranks(2, backend, h_cfg, "hovering", "hovering", plain,
                       pdist.VECTOR_TOL, 1, witness=witness)
    for r in reports:
        check(r["launches"] == {"fused_rollout/hovering": 2},
              f"hovering rank {r['rank']}: launches {r['launches']}, "
              f"expected 2 rollout launches and no update kernel")
    p_cfg = cfg_of(p_yaml, 1)
    plain = one_process(p_cfg, "planning", "planning", shares=1)
    witness = one_process(p_cfg, "planning", "planning_w2", shares=2)
    reports, _ = ranks(2, backend, p_cfg, "planning", "planning", plain,
                       pdist.VISION_TOL, 1, ROLLOUT_METRICS, witness)
    hc = int(p_cfg["params"]["config"]["horizon_length"])
    for r in reports:
        check(r["launches"] == {"render_process/render_process":
                                1 + hc // PlanningCfg().cam_every},
              f"planning rank {r['rank']}: launches {r['launches']}")

    h1 = cfg_of(h_yaml, 1)
    plain = one_process(h1, "hovering", "hovering_1")
    reports, bitwise = ranks(1, "nccl", h1, "hovering", "hovering_1", plain,
                             pdist.VECTOR_TOL, 1)
    check(bitwise, "one rank over NCCL: the epoch differs from the "
                   "one-process epoch, want bitwise equal")
    check(reports[0]["launches"] == {"fused_rollout/hovering": 1,
                                     "fused_update/obs18": 1,
                                     **prep_launched(1)},
          f"one rank over NCCL: launches {reports[0]['launches']}")
    print(f"[multi-gpu hovering_1] backend nccl world 1: the epoch is "
          f"bitwise the one-process epoch (parameters and metrics)",
          flush=True)


def native_cascade(card):
    """Phase 34: the host-side C++ cascade (control/native.py) at
    NATIVE_ENVS in all five modes for NATIVE_STEPS steps of seeded random
    states and actions, a random reset mask every NATIVE_RESET_EVERY
    steps, against px4.run on the card: commands and the five state
    fields within NATIVE_ATOL. Prints the g++ build's seconds and the ms
    per step of each after the first (the CUDA cascade's up to a device
    sync)."""
    from airgym_tpu_torch.control import native, px4
    fresh = not native.lib_path().exists()
    t0 = time.perf_counter()
    native.build()
    print(f"[native] g++ build {time.perf_counter() - t0:.2f} s "
          f"({'built' if fresh else 'found'} {native.lib_path().name}) "
          f"[{card}]", flush=True)
    rng = np.random.default_rng(34)
    n, g, dev = NATIVE_ENVS, px4.CascadeGains(), torch.device("cuda")

    def states():
        q = rng.normal(size=(n, 4))
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        return np.concatenate([rng.uniform(-2, 2, (n, 3)), q,
                               rng.uniform(-3, 3, (n, 6))],
                              1).astype(np.float32)

    for mode in px4.CONTROL_MODES:
        ctl = native.ParallelControl(mode, n)
        cs = px4.init_state(n, device=dev)
        host_s = dev_s = worst = 0.0
        for step in range(NATIVE_STEPS):
            root = states()
            act = rng.uniform(-1, 1, (n, px4.num_actions(mode))).astype(
                np.float32)
            if mode in ("rate", "atti", "prop"):
                act[:, -1] = np.abs(act[:, -1])
            if step and step % NATIVE_RESET_EVERY == 0:
                mask = rng.random(n) < 0.5
                ctl.reset(mask, root[:, 3:7])
                cs = px4.reset_state(cs, torch.from_numpy(mask).to(dev),
                                     torch.from_numpy(root[:, 3:7]).to(dev))
            root_d, act_d = (torch.from_numpy(a).to(dev) for a in (root, act))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cmds_d, cs = px4.run(mode, g, cs, root_d, act_d, 0.01)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            cmds_n = ctl.update(root, act, 0.01)
            if step:                    # the first step of each warms up
                host_s += time.perf_counter() - t1
                dev_s += t1 - t0
            st = ctl.state_as_cascade_state(dev)
            errs = [(cmds_d - torch.from_numpy(cmds_n).to(dev)).abs().max()]
            errs += [(getattr(cs, f) - getattr(st, f)).abs().max()
                     for f in px4.CascadeState._fields]
            worst = max(worst, float(torch.stack(errs).max()))
        check(worst <= NATIVE_ATOL,
              f"native cascade {mode}: max |err| {worst:.3e} > {NATIVE_ATOL}")
        timed = NATIVE_STEPS - 1
        print(f"[native {mode}] {n} envs x {NATIVE_STEPS} steps: max |err| "
              f"{worst:.3e} (commands and state, tol {NATIVE_ATOL}); ms per "
              f"step (the last {timed}) host C++ {1e3 * host_s / timed:.4f},"
              f" CUDA px4.run {1e3 * dev_s / timed:.4f} [{card}]",
              flush=True)


def library_on_card(card):
    """Phase 35: the losses, the moving-stats updates, TensorPID and the
    replay ring, each on the card and on the CPU from the same inputs:
    results within LIB_RTOL of max|ref|, ring contents bitwise equal.
    Prints the ring's bytes and its ms per add and per sample."""
    from airgym_tpu_torch.rl import losses
    from airgym_tpu_torch.rl import moving_stats as ms
    from airgym_tpu_torch.rl import replay
    from airgym_tpu_torch.utils import tensor_pid
    dev, cpu = torch.device("cuda"), torch.device("cpu")
    gen = torch.Generator().manual_seed(35)
    rand = lambda *shape: torch.randn(shape, generator=gen)
    b, a = LIB_MINIBATCH, LIB_ACTIONS
    old = rand(b)
    new, adv, proxy = old + 0.3 * rand(b), rand(b), old + 0.2 * rand(b)
    mu0, mu1 = 1.5 * rand(b, a), 1.5 * rand(b, a)
    s0, s1 = torch.exp(0.3 * rand(b, a) - 0.5), torch.exp(0.3 * rand(b, a))
    vp, v, ret = 2 * rand(b), 2 * rand(b), 2 * rand(b)
    batch = 3.0 + 2.0 * rand(3, LIB_BATCH)
    errs = rand(6, 4096, 3)
    pid = tensor_pid.TensorPID(kp=1.0, ki=0.5, kd=0.1, integral_lim=0.05,
                               derivative_lim=30.0, output_lim=1.5)

    def run(d):
        to = lambda *xs: [x.to(d) for x in xs]
        o, nw, ad, px, m0, m1, z0, z1, p, vv, r = to(
            old, new, adv, proxy, mu0, mu1, s0, s1, vp, v, ret)
        out = {}
        for name in ("actor_loss", "smoothed_actor_loss"):
            out[name] = getattr(losses, name)(o, nw, ad, True, 0.2)
        for clip in (True, False):
            out[f"critic_loss[{clip}]"] = losses.critic_loss(p, vv, 0.2, r,
                                                             clip)
        out["decoupled_actor_loss"] = losses.decoupled_actor_loss(
            o, nw, px, ad, 0.2)
        out["bound_loss"] = losses.bound_loss(m0)
        out["policy_kl"] = losses.policy_kl(m0, z0, m1, z1, False)
        out["explained_variance"] = losses.explained_variance(nw, o)
        out["policy_clip_fraction"] = losses.policy_clip_fraction(nw, o, 0.2)
        for upd in ("update_mean_std", "update_min_max", "update_percentile"):
            st = ms.MovingStats.create((), device=d)
            for x in batch.to(d):
                st = getattr(ms, upd)(st, x)
            out[f"{upd}.center"], out[f"{upd}.scale"] = st.center, st.scale
            out[f"{upd}.denormalize"] = ms.denormalize(st, ad)
        st = pid.init((4096, 3), device=d)
        for i, e in enumerate(errs.to(d)):
            u, st = pid.step(st, e, 0.01)
            if i == 3:
                st = pid.reset(st, e[:, 0] > 0)
            out[f"pid[{i}]"] = u
        return out

    on_card, on_cpu = run(dev), run(cpu)
    worst = 0.0
    for k, ref in on_cpu.items():
        err = float((on_card[k].cpu() - ref).abs().max())
        tol = LIB_RTOL * max(float(ref.abs().max()), 1e-30)
        check(err <= tol, f"library {k}: card vs CPU {err:.3e} > {tol:.3e}")
        worst = max(worst, err / max(float(ref.abs().max()), 1e-30))
    print(f"[library] {len(on_cpu)} results (losses at {b} x {a}, moving "
          f"stats over {LIB_BATCH}, TensorPID over 4096 x 3): card vs CPU "
          f"within {worst:.3e} of max|ref| (tol {LIB_RTOL}) [{card}]",
          flush=True)

    # the replay ring: Hovering's transitions, 4096-env batches past a wrap
    n, cap = NATIVE_ENVS, REPLAY_CAPACITY
    rings = {"card": replay.VectorizedReplayBuffer((18,), (4,), cap,
                                                   device="cuda"),
             "host": replay.VectorizedReplayBuffer((18,), (4,), cap,
                                                   device="cpu")}
    states = {d: r.create() for d, r in rings.items()}
    row_bytes = sum(x[0].numel() * x.element_size()
                    for x in states["card"][:5])
    g_dev = torch.Generator(device=dev)
    g_dev.manual_seed(35)
    add_ms = []
    for i in range(REPLAY_ADDS):
        obs = torch.rand((n, 18), generator=g_dev, device=dev)
        obs[:, 0] = torch.arange(i * n, (i + 1) * n, device=dev,
                                 dtype=torch.float32)
        tr = (obs, torch.rand((n, 4), generator=g_dev, device=dev),
              torch.rand((n,), generator=g_dev, device=dev),
              torch.rand((n, 18), generator=g_dev, device=dev),
              torch.rand((n,), generator=g_dev, device=dev) < 0.05)
        ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        ev0.record()
        states["card"] = rings["card"].add(states["card"], *tr)
        ev1.record()
        states["host"] = rings["host"].add(states["host"],
                                         *(x.cpu() for x in tr))
        ev1.synchronize()
        add_ms.append(ev0.elapsed_time(ev1))
    sc, sh = states["card"], states["host"]
    for f in replay.VectorizedReplayState._fields:
        check(torch.equal(getattr(sc, f).cpu(), getattr(sh, f)),
              f"replay ring: field {f} differs between the card and the CPU")
    check(bool(sc.full) and int(sc.idx) == (REPLAY_ADDS * n) % cap,
          f"replay ring: cursor {int(sc.idx)}, full {bool(sc.full)}")
    sample = lambda: rings["card"].sample(sc, g_dev, REPLAY_SAMPLE)
    obs, act, rew, nobs, done = sample()
    t = obs[:, 0].long().cpu()
    check(bool((t >= REPLAY_ADDS * n - cap).all()),
          "replay sample: a row that the ring overwrote")
    slot = t % cap
    for x, buf in ((obs, sh.obs), (act, sh.actions), (rew, sh.rewards),
                   (nobs, sh.next_obs), (done, sh.dones)):
        check(torch.equal(x.cpu(), buf[slot]),
              "replay sample: a row that is not the stored one")
    sample_ms = cuda_time_ms(sample)
    print(f"[replay] ring of {cap} rows x {row_bytes} B = "
          f"{cap * row_bytes / 1e6:.1f} MB on the card, {REPLAY_ADDS} adds "
          f"of {n} (wrapped), ring bitwise the CPU's; ms per add "
          f"{statistics.median(add_ms):.4f} (median), per sample of "
          f"{REPLAY_SAMPLE} {sample_ms:.4f} [{card}]", flush=True)


def _read_lines(sock, want, deadline_s, out):
    """Append to ``out`` up to ``want`` JSON lines (None for a line that
    does not parse) within ``deadline_s`` seconds."""
    sock.settimeout(0.5)
    buf = b""
    end = time.monotonic() + deadline_s
    while len(out) < want and time.monotonic() < end:
        try:
            data = sock.recv(1 << 16)
        except TimeoutError:
            continue
        except OSError:
            break
        if not data:
            break
        buf += data
        while b"\n" in buf:
            line, buf = buf.split(b"\n", 1)
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:
                out.append(None)


def stream_bridge(runner_mod, h_yaml, checkpoint, card):
    """Phase 36: run_bridged_play on the card at Hovering's YAML width from
    ``checkpoint`` for STREAM_STEPS steps, a loopback client that sends
    STREAM_TARGET before the run and reads every line; the published env-0
    actions and roots bitwise a replay of the same boot without a server
    with the target from step 1; then stream_play.main once against a
    client. Prints the bridged loop's steps/s."""
    import socket
    import threading
    from airgym_tpu_torch import stream_play
    from airgym_tpu_torch.utils import action_stream as ast
    task, trainer, _ = runner_mod.Runner().load(h_yaml).build({
        "task": "hovering", "ctl_mode": "rate", "device": "cuda"})
    ts = runner_mod.restore(trainer.init(0), checkpoint)
    n = task.cfg.num_envs
    server = ast.ActionStreamServer()
    client = socket.create_connection(server.address, timeout=10)
    lines = []
    try:
        client.sendall((json.dumps({"target_state": STREAM_TARGET})
                        + "\n").encode())
        reader = threading.Thread(target=_read_lines, daemon=True, args=(
            client, STREAM_STEPS, 300.0, lines))
        reader.start()
        t0 = time.perf_counter()
        ast.run_bridged_play(task, trainer, ts, server, STREAM_STEPS,
                             seed=STREAM_SEED, device="cuda")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        reader.join(timeout=60)
        check(not reader.is_alive(), "stream: the client is still reading")
    finally:
        client.close()
        server.close()
    check(len(lines) == STREAM_STEPS and None not in lines,
          f"stream: {len(lines)} lines, {lines.count(None)} torn; want "
          f"{STREAM_STEPS} whole")
    check([m["step"] for m in lines] == list(range(STREAM_STEPS)),
          "stream: the lines are not in step order")
    check(all(len(m["action"]) == 4 and len(m["root_state"]) == 13
              for m in lines), "stream: a line of the wrong lengths")
    check(server.dropped == 0, f"stream: {server.dropped} lines dropped")

    # the replay: the same boot, the target from step 1, no server
    with torch.no_grad():
        gen = torch.Generator(device="cuda")
        gen.manual_seed(STREAM_SEED)
        state = task.initial_state(gen)
        state, out = task.step(state, torch.zeros(
            (n, task.cfg.num_actions), device="cuda"), gen)
        step_fn = ast.make_retargetable_step(task)
        target, rows = task.target, []
        new_target = torch.tensor(STREAM_TARGET, device="cuda").expand(
            task.target.shape)
        for t in range(STREAM_STEPS):
            mu, _, _ = ts.model(out.obs, trainer._rms(ts))
            action = torch.clamp(mu, -1.0, 1.0)
            state, out = step_fn(state, action, target, gen)
            rows.append(torch.cat([action[0], state.core.root[0, :13]]))
            target = new_target
        rows = torch.stack(rows).cpu().numpy()
    got = np.array([m["action"] + m["root_state"] for m in lines],
                   np.float32)
    check(np.array_equal(got, rows), "stream: the published actions / roots "
          "differ from the replay with the target from step 1")
    moved = float(np.abs(rows[-1, 4:7] - np.array([1.0, -0.5, 0.5])).max())
    print(f"[stream] {n} envs x {STREAM_STEPS} steps bridged: "
          f"{STREAM_STEPS / secs:.1f} steps/s ({1e3 * secs / STREAM_STEPS:.3f}"
          f" ms per step with its host copy and socket I/O); {len(lines)} "
          f"whole lines, bitwise the replay; env 0 ends {moved:.3f} m from "
          f"the streamed target [{card}]", flush=True)

    clients = []

    class Connected(ast.ActionStreamServer):
        """A server with a client connected before the first publish."""

        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            clients.append(socket.create_connection(self.address,
                                                    timeout=10))

    stream_play.ActionStreamServer = Connected
    try:
        rc = stream_play.main(["--device", "cuda", "--steps", "50", "--hz",
                               "0", "--port", "0", "--num_envs", str(n),
                               "--checkpoint", checkpoint[:-3] + ".pth"])
        got = []
        _read_lines(clients[0], 50, 60.0, got)
    finally:
        stream_play.ActionStreamServer = ast.ActionStreamServer
        for c in clients:
            c.close()
    check(rc == 0 and len(got) == 50 and None not in got
          and [m["step"] for m in got] == list(range(50)),
          f"stream_play.main: rc {rc}, {len(got)} lines")
    print(f"[stream_play] python -m airgym_tpu_torch.stream_play --device "
          f"cuda --steps 50 --hz 0 --num_envs {n}: 50 whole lines [{card}]",
          flush=True)


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a GPU")

    from airgym_tpu_torch import cli
    from airgym_tpu_torch import envs
    from airgym_tpu_torch.experiments import fused_cnn as fc
    from airgym_tpu_torch.kernels import build
    from airgym_tpu_torch.kernels import hovering_ab as ha
    from airgym_tpu_torch.kernels import render_ab as ra
    from airgym_tpu_torch.models.actor_critic import CNNEncoder
    from airgym_tpu_torch.models.actor_critic import ActorCritic
    from airgym_tpu_torch.ops import epoch_prep as ep
    from airgym_tpu_torch.ops import fused_hovering as fh
    from airgym_tpu_torch.ops import fused_rollout as fr
    from airgym_tpu_torch.ops import fused_update as fu
    from airgym_tpu_torch.render import raycast as rc
    from airgym_tpu_torch.rl import checkpoint as ckpt
    from airgym_tpu_torch.rl import runner as runner_mod
    from airgym_tpu_torch.rl.fused_ppo import FusedHoveringPPO
    from airgym_tpu_torch.rl.runner import ppo_config_from_params
    from airgym_tpu_torch.rl.running_stats import RunningMeanStd
    import yaml

    dev = torch.device("cuda")
    # ---- 1. card ----------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else \
        "nvidia-smi: not available"
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    # ---- 2. build ---------------------------------------------------------
    phase(2)
    kernels = [fr.KERNEL, fu.KERNEL, ep.KERNEL, fh.KERNEL, rc.KERNEL,
               rc.DEPTH_KERNEL, fc.KERNEL]
    # the rollout source once more with its phase clocks (phases 6 and 11)
    fr_clk = build.CudaKernel(
        "fused_rollout", {**fr.KERNEL.entry_points,
                          "fused_rollout_phase_cycles": [ctypes.c_void_p]},
        extra_flags=["-DAIRGYM_ROLLOUT_CLOCKS"])
    # the two render sources once more with their phase clocks (phases 12
    # and 19) and SASS probes
    rc_clk = ra.kernels(None, clocks=True)
    # the env-only source once more with its phase clocks and counters
    # (phase 11)
    fh_clk = ha.kernel_build(clocks=True)
    secs = build.build_all(kernels + [fr_clk, *rc_clk.values(), fh_clk])
    print(f"[build] {len(kernels)} kernels and 4 clock builds in {secs:.1f} "
          f"s", flush=True)
    for k in kernels + list(rc_clk.values()):
        tag = k.name + (" (clock build)" if k in rc_clk.values() else "")
        for line in k.build_log.splitlines():
            if ("registers" in line or "spill" in line or "error" in line
                    or "Compiling entry" in line):
                print(f"[build] {tag}: {line.strip()}", flush=True)
    for k in (rc.KERNEL, rc.DEPTH_KERNEL, fh.KERNEL):
        check(all(" 0 bytes spill stores" in line
                  for line in k.build_log.splitlines() if "spill" in line),
              f"{k.name} spills registers at its launch bounds")
    env_shape, env_shape_line = ha.shape_line(fh.KERNEL)
    print(f"[build] fused_hovering at {ha.N_ENVS} envs: {env_shape_line}",
          flush=True)
    check(env_shape["per_sm"] * torch.cuda.get_device_properties(0)
          .multi_processor_count >= env_shape["blocks"],
          f"env-only kernel needs more than one wave: {env_shape}")
    env_sass = ha.loop_sass(fh.KERNEL)
    check(bool(env_sass) and env_sass["hot_reset"] is not None,
          f"no SASS counts of the env-only step loop: {env_sass}")
    print(f"[build] fused_hovering SASS (static): kernel "
          f"{env_sass['kernel']}, step loop {env_sass['loop']} ({env_sass['hot']} "
          f"without cold paths), reset block behind the vote "
          f"{env_sass['reset']} ({env_sass['hot_reset']})", flush=True)
    print(f"[build] render_process: dynamic shared memory "
          f"{rc.KERNEL.lib().render_process_smem_bytes(48, 212, 120)} bytes "
          f"per block at 212 x 120 with 48 records", flush=True)
    print(f"[build] render_depth: dynamic shared memory "
          f"{rc.DEPTH_KERNEL.lib().render_depth_smem_bytes(168, 212, 120)} "
          f"bytes per block with 168 records at 212 x 120", flush=True)
    sass = ra.sass_counts(rc_clk["render_depth"])
    body = ra.cast_body_counts(sass)
    check(bool(body) and len(body) == 4,
          f"no SASS counts of the cast bodies: {sorted(sass)[:4]}")
    print(f"[build] SASS instructions of one record's cast body (the clock "
          f"build's sass_probe<KIND> less the empty probe): {body}; the "
          f"parent design's {PARENT_CAST_SASS}", flush=True)
    for k in rc_clk.values():
        total = {fn: c for fn, c in ra.sass_counts(k).items()
                 if "sass_probe" not in fn}
        print(f"[build] SASS instructions of {k.name}'s kernel: "
              f"{list(total.values())}", flush=True)
    print(f"[build] fused_cnn: dynamic shared memory "
          f"{fc.KERNEL.lib().fused_cnn_smem_bytes(212, 120)} bytes per block "
          f"of the float32 kernels at 212 x 120; forward workspace "
          f"{fc.KERNEL.lib().fused_cnn_fwd_workspace_bytes(212, 120, 1)} "
          f"bytes per block in bf16; backward workspace "
          f"{4 * fc.KERNEL.lib().fused_cnn_workspace_floats(212, 120, 1)} "
          f"bytes per block in bf16, "
          f"{4 * fc.KERNEL.lib().fused_cnn_workspace_floats(212, 120, 0)} in "
          f"float32", flush=True)

    cfg_dir = os.path.join(os.path.dirname(os.path.abspath(fr.__file__)),
                           "..", "configs")

    def load_cfg(task):
        with open(os.path.join(cfg_dir, f"ppo_{task}.yaml")) as f:
            return yaml.safe_load(f)

    run_root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "build", "chip_smoke_runs")
    yaml_cfg = load_cfg("hovering")
    params = yaml_cfg["params"]
    n_envs = int(params["config"]["num_actors"])
    pcfg = ppo_config_from_params(params)

    task = envs.make_task("hovering", ctl_mode="rate", num_envs=n_envs,
                          device=dev)
    trainer = FusedHoveringPPO(task, pcfg)
    ts = trainer.init(1234)

    # ---- 3. rollout kernel vs plain ---------------------------------------
    phase(3)
    pack = fr.pack_policy(ts.model, ts.obs_rms)
    packed = fh.pack_state(ts.env_state.core)
    packed[19, :256] = 2390.0            # exercise the timeout path too
    seed, H = 987654321, pcfg.horizon
    rollout_err = {}
    for alpha in (0.0, 0.6):
        err, _, _, _ = rollout_vs_plain(fr, packed, pack, seed, H,
                                        "hovering", alpha)
        if alpha == 0.0:
            rollout_err["hovering"] = err

    # ---- 4. update kernel vs plain ----------------------------------------
    phase(4)
    g = torch.Generator(device=dev)
    g.manual_seed(7)
    B = trainer.batch_size
    nmb, me = trainer.num_minibatches, pcfg.mini_epochs
    upd_args, upd_kw = update_case(fu, ts.model, ts.obs_rms, g, B, 18,
                                   ts.lr, pcfg, nmb)
    update_err = {"obs18": update_vs_plain(fu, upd_args, upd_kw, "obs18")}
    prep_kw = dict(gamma=pcfg.gamma, tau=pcfg.tau,
                   reward_scale=pcfg.reward_shaper_scale,
                   value_bootstrap=pcfg.value_bootstrap)
    prep_cases = {f"obs{k}": prep_case(dev, k, n_envs, H, 21 + k)
                  for k in (18, 48)}
    prep_err = {tag: prep_vs_plain(ep, c, prep_kw, tag)
                for tag, c in prep_cases.items()}

    # ---- 5. train through the runner --------------------------------------
    phase(5)
    reset_counts(kernels)
    _, ts_run, info = train_and_reload(runner_mod, ckpt, yaml_cfg,
                                       "hovering", EPOCHS, run_root, g,
                                       kernels)
    hover_checkpoint = info["checkpoint"]      # phase 36 plays it
    launches = {"hovering": fr.KERNEL.launches["hovering"],
                "obs18": fu.KERNEL.launches["obs18"],
                **{f"prep_{ph}[obs18]": ep.KERNEL.launches[ph]
                   for ph in ep.PHASES}}
    print(f"[train hovering] {EPOCHS} epochs in {info['train_s']:.2f} s; "
          f"launches {launches}", flush=True)
    check(launches["hovering"] == EPOCHS,
          f"rollout kernel launches {launches['hovering']} != "
          f"{EPOCHS} (1 per epoch)")
    check(launches["obs18"] == EPOCHS,
          f"update kernel launches {launches['obs18']} != {EPOCHS} (1 per "
          f"epoch)")
    for ph in ep.PHASES:
        check(launches[f"prep_{ph}[obs18]"] == EPOCHS,
              f"prep {ph} kernel launches {launches[f'prep_{ph}[obs18]']} "
              f"!= {EPOCHS} (1 per epoch)")
    check(float(ts_run.adam["count"][0]) == EPOCHS * nmb * me,
          f"hovering Adam count {float(ts_run.adam['count'][0])} != "
          f"{EPOCHS * nmb * me} ({nmb * me} steps per epoch)")

    # ---- 6. timing ----------------------------------------------------------
    phase(6)
    times = {}
    n, steps = packed.shape[1], H
    times["hovering"] = (
        cuda_time_ms(lambda: fr.rollout_fused_policy(packed, pack, seed,
                                                     steps)),
        cuda_time_ms(lambda: fr.rollout_fused_policy_plain(
            packed, pack, seed, steps), PLAIN_REPS),
        *rollout_bound("hovering", n, steps, fr.flat_policy(pack).numel()))
    times["obs18"] = (
        cuda_time_ms(lambda: fu.fused_update(*upd_args, **upd_kw)),
        cuda_time_ms(lambda: fu.fused_update_plain(*upd_args, **upd_kw),
                     PLAIN_REPS),
        *update_bound(18, B, me))
    rollout_shape_and_split(fr, fr_clk, "hovering", packed, pack, seed, steps,
                            times)
    for tag, c in prep_cases.items():
        prep_times(ep, c, prep_kw, times, tag)
    k_ms, p_ms, b_ms, b_by = times["obs18"]
    print(f"[time] obs18: kernel {k_ms:.3f} ms (G={fu.grid_size(18, dev)} "
          f"blocks, plain {p_ms:.3f}, bound {b_ms:.4f} by {b_by})",
          flush=True)
    # the persistent grid capped at half the default, for comparison
    cap = fu.GRID_CAP
    fu.GRID_CAP = cap // 2
    half_ms = cuda_time_ms(lambda: fu.fused_update(*upd_args, **upd_kw))
    print(f"[time] obs18 at G={fu.grid_size(18, dev)} blocks: kernel "
          f"{half_ms:.3f} ms", flush=True)
    fu.GRID_CAP = cap

    # ---- 7. where one epoch's time goes (torch.profiler) --------------------
    phase(7)
    prep_expect = {f"epoch_prep_{ph}_kernel": 1 for ph in ep.PHASES}
    profile_epoch(trainer, ts_run, "hovering",
                  expect={"update_kernel": 1, **prep_expect})

    # ---- 8. Balloon / Tracking rollouts, the update at 48 features ---------
    phase(8)
    task_inputs = {}
    for name in ("balloon", "tracking"):
        t_cfg = ppo_config_from_params(load_cfg(name)["params"])
        t_task = envs.make_task(name, ctl_mode="rate", num_envs=n_envs,
                                device=dev)
        state = t_task.initial_state(torch.Generator(device=dev)
                                     .manual_seed(11))
        model = ActorCritic(t_task.num_obs, 4, generator=torch.Generator()
                            .manual_seed(3)).to(dev)
        rms = RunningMeanStd.create((t_task.num_obs,), dev).update(
            torch.randn((4096, t_task.num_obs), generator=g, device=dev))
        t_pack = fr.pack_policy(model, rms)
        if name == "balloon":
            p = fr.pack_state_balloon(state.core, state.balloon,
                                      state.pre_root_pos)
            p[7, :512] = p[7, :512].abs() + 0.3   # fly forward: survive
            p[19, :256] = 790.0                    # ... to the time-out
            p[29:32, 512:640] = p[0:3, 512:640] + torch.tensor(
                [[0.06], [0.02], [0.0]], device=dev)  # balloon hits
        else:
            p = fh.pack_state(state.core)
            p[19, :256] = 3590.0                   # time out, on track
            ref = t_task.ref_trajectory(p[19, :256].to(torch.int32) + 1)
            p[0:3, :256] = ref[:, 0].T
            p[0, 256:384] += 1.5                   # off track: die
        err, n_reset, n_timeout, n_hit = rollout_vs_plain(
            fr, p, t_pack, seed, t_cfg.horizon, name)
        check(n_reset > 0 and n_timeout > 0 and (n_hit > 0
                                                 or name != "balloon"),
              f"{name} rollout window lacks resets / timeouts / hits")
        rollout_err[name] = err
        task_inputs[name] = (p, t_pack, t_cfg.horizon)
        if name == "balloon":
            # the 18-feature update at Balloon's shape: B = 131,072, 64
            # minibatches (320 Adam steps in one launch)
            Bb = n_envs * t_cfg.horizon
            updb_args, updb_kw = update_case(
                fu, model, rms, g, Bb, 18, ts.lr, t_cfg,
                Bb // t_cfg.minibatch_size)
            update_err["obs18"] = max(update_err["obs18"], update_vs_plain(
                fu, updb_args, updb_kw, "obs18 balloon"))
            del updb_args
        if name == "tracking":
            B48 = n_envs * t_cfg.horizon
            nmb48 = B48 // t_cfg.minibatch_size
            upd48_args, upd48_kw = update_case(
                fu, model, rms, g, B48, 48, ts.lr, t_cfg, nmb48)
            update_err["obs48"] = update_vs_plain(fu, upd48_args, upd48_kw,
                                                  "obs48")

    # ---- 9. env-only Hovering kernel ------------------------------------------
    phase(9)
    e_task = envs.make_task("hovering", ctl_mode="rate", num_envs=n_envs,
                            device=dev)
    e_packed = fh.pack_state(e_task.initial_state(
        torch.Generator(device=dev).manual_seed(13)).core)
    e_packed[19, :256] = 2380.0
    big, env_acts = ha.traffic(dev)
    act = env_acts["climb"]
    out_k, rew_k = fh.rollout_fused(e_packed, act, 99, ha.STEPS)
    env_err, rew_err = env_vs_plain(fh, e_packed, act, 99, ha.STEPS, out_k,
                                    rew_k, "climb")
    reset_counts(kernels)
    out_big, rew_big = fh.rollout_fused(big, act, ha.SEED, ha.STEPS)
    torch.cuda.synchronize()
    launches["env"] = fh.KERNEL.launches["env"]
    check(launches["env"] == 1 and sum(fr.KERNEL.launches.values()) == 0,
          f"env-only path launches {launches['env']} != 1")
    check(bool(torch.isfinite(out_big[:29]).all())
          and bool(torch.isfinite(rew_big).all()),
          "env-only run at full size is not finite")
    qn = out_big[3:7].norm(dim=0)
    check(float((qn - 1.0).abs().max()) < 1e-3, "env-only: quats not unit")
    # the main path's own launch against the plain version at its shape,
    # then the reference bench's hover action at the same shape
    for name, a in env_acts.items():
        res = (out_big, rew_big) if name == "climb" else \
            fh.rollout_fused(big, a, ha.SEED, ha.STEPS)
        errs = env_vs_plain(fh, big, a, ha.SEED, ha.STEPS, *res, name)
        env_err, rew_err = max(env_err, errs[0]), max(rew_err, errs[1])

    # ---- 10. Balloon and Tracking training ------------------------------------
    phase(10)
    paths = {"balloon": ("balloon", "obs18"),
             "tracking": ("tracking", "obs48")}
    for name, (rkey, ukey) in paths.items():
        reset_counts(kernels)
        t_trainer, t_ts, t_info = train_and_reload(
            runner_mod, ckpt, load_cfg(name), name, TASK_EPOCHS, run_root, g,
            kernels, num_envs=n_envs)
        got = {rkey: fr.KERNEL.launches[rkey], ukey: fu.KERNEL.launches[ukey],
               **{f"prep_{ph}[{ukey}]": ep.KERNEL.launches[ph]
                  for ph in ep.PHASES}}
        print(f"[train {name}] {TASK_EPOCHS} epochs in "
              f"{t_info['train_s']:.2f} s; launches {got}", flush=True)
        check(got[rkey] == TASK_EPOCHS,
              f"{name} rollout launches {got[rkey]} != {TASK_EPOCHS}")
        check(got[ukey] == TASK_EPOCHS,
              f"{name} update launches {got[ukey]} != {TASK_EPOCHS} (1 per "
              f"epoch)")
        for ph in ep.PHASES:
            check(got[f"prep_{ph}[{ukey}]"] == TASK_EPOCHS,
                  f"{name} prep {ph} launches {got[f'prep_{ph}[{ukey}]']} "
                  f"!= {TASK_EPOCHS} (1 per epoch)")
        steps = t_trainer.num_minibatches * t_trainer.cfg.mini_epochs
        check(float(t_ts.adam["count"][0]) == TASK_EPOCHS * steps,
              f"{name} Adam count {float(t_ts.adam['count'][0])} != "
              f"{TASK_EPOCHS * steps} ({steps} steps per epoch)")
        launches[rkey] = got[rkey]
        for key in (ukey, *(f"prep_{ph}[{ukey}]" for ph in ep.PHASES)):
            launches.setdefault(key, got[key])
        if name == "balloon":
            for row in t_info["history"]:
                check(0.0 <= row["success_rate"] <= 1.0,
                      f"balloon success_rate {row['success_rate']}")
        profile_epoch(t_trainer, t_ts, name,
                      expect={"update_kernel": 1, **prep_expect})

    # ---- 11. timing of the new kernels, the kernels line ------------------------
    phase(11)
    for name, (p, t_pack, steps_t) in task_inputs.items():
        times[name] = (
            cuda_time_ms(lambda: fr.rollout_fused_policy(
                p, t_pack, seed, steps_t, task=name)),
            cuda_time_ms(lambda: fr.rollout_fused_policy_plain(
                p, t_pack, seed, steps_t, task=name), PLAIN_REPS),
            *rollout_bound(name, p.shape[1], steps_t,
                           fr.flat_policy(t_pack).numel()))
    times["obs48"] = (
        cuda_time_ms(lambda: fu.fused_update(*upd48_args, **upd48_kw)),
        cuda_time_ms(lambda: fu.fused_update_plain(*upd48_args, **upd48_kw),
                     PLAIN_REPS),
        *update_bound(48, upd48_args[0].shape[0], upd48_kw["mini_epochs"]))
    # the env-only kernel under both traffics: its counters (clock build)
    # on the same inputs give the resets the bound counts
    env_runs = {"climb": ha.STEPS, "hover": ha.LONG_STEPS}
    env_counts = {
        name: ha.counts(fh_clk, lambda a=a, t=env_runs[name]:
                        ha.run(fh_clk, big, a, t))
        for name, a in env_acts.items()}
    resets = env_counts["climb"][0][5]
    times["env"] = (
        cuda_time_ms(lambda: fh.rollout_fused(big, act, ha.SEED, ha.STEPS)),
        cuda_time_ms(lambda: fh.rollout_fused_plain(big, act, ha.SEED,
                                                    ha.STEPS), PLAIN_REPS),
        *ha.bound(ha.N_ENVS, ha.STEPS, resets)[2:])
    hover = env_acts["hover"]
    hover_ms = cuda_time_ms(lambda: fh.rollout_fused(big, hover, ha.SEED,
                                                     ha.LONG_STEPS), 5)
    env_clocks = {
        "nvidia-smi": ha.sm_clock_mhz(lambda: fh.rollout_fused(
            big, hover, ha.SEED, ha.LONG_STEPS), 20),
        "clock build, hover x 8000": ha.block_mhz(*env_counts["hover"],
                                                  ha.N_ENVS)}
    for name, (p, t_pack, steps_t) in task_inputs.items():
        rollout_shape_and_split(fr, fr_clk, name, p, t_pack, seed, steps_t,
                                times)
    k_ms, p_ms, b_ms, b_by = times["obs48"]
    print(f"[time] obs48: kernel {k_ms:.3f} ms (G={fu.grid_size(48, dev)} "
          f"blocks, plain {p_ms:.3f}, bound {b_ms:.4f} by {b_by})", flush=True)
    for name, steps_e in env_runs.items():
        c, c_ms = env_counts[name]
        ms = times["env"][0] if name == "climb" else hover_ms
        ops, nbytes, b_ms, b_by = ha.bound(ha.N_ENVS, steps_e,
                                           c[5] if name == "climb" else 0)
        old_b = ha.bound(ha.N_ENVS, steps_e, 0, ha.PARENT_STEP_OPS)[2]
        # the plain version is too slow at 8000 steps; without the resets
        # the count is still a lower bound
        plain, counted = ((f"plain {times['env'][1]:.3f} ms, ",
                           f"the window's {c[5]} resets") if name == "climb"
                          else ("", "no resets counted"))
        print(f"[time] env-only {name}: kernel {ms:.4f} ms at {ha.N_ENVS} x "
              f"{steps_e} ({ha.N_ENVS * steps_e / ms / 1e6:.2f} G env-steps/s; "
              f"the parent design's {PARENT_ENV_MS[name]} ms), {plain}bound "
              f"{b_ms:.4f} ms by {b_by} ({ops / 1e9:.3f} GFLOP with "
              f"{counted}; the parent design's count {old_b:.4f} ms)",
              flush=True)
        print(f"[time] env-only {name}: clock build at {ha.N_ENVS} x "
              f"{steps_e}: {ha.split_line(c, c_ms, ha.N_ENVS, steps_e)}",
              flush=True)
        print(f"[time] env-only {name}: "
              f"{ha.issue_line(env_sass, c, ha.N_ENVS, steps_e, env_clocks)}",
              flush=True)

    # ---- 12. the render + post-process kernel vs its plain version ---------
    phase(12)
    render_err, render_cases = render_checks(ra, rc, dev)
    for tag in ("planning 4096 guarded", "box 1024 unguarded"):
        render_split(ra, rc_clk["render_process"], render_cases[tag], tag)

    # ---- 13. Planning training -----------------------------------------------
    phase(13)
    p_yaml = load_cfg("planning")
    reset_counts(kernels)
    p_trainer, p_ts, p_info = train_and_reload(
        runner_mod, ckpt, p_yaml, "planning", PLANNING_EPOCHS, run_root, g,
        kernels)
    got = p_info["launches"]
    launches["render_process"] = got["render_process"].get(
        "render_process", 0)
    want = 1 + PLANNING_EPOCHS * (p_trainer.cfg.horizon
                                  // p_trainer.cam_every)
    print(f"[train planning] {PLANNING_EPOCHS} epochs in "
          f"{p_info['train_s']:.2f} s; launches {got}", flush=True)
    check(launches["render_process"] == want,
          f"planning render launches {launches['render_process']} != {want} "
          f"(1 at init + horizon / cam_every per epoch)")
    check(sum(sum(v.values()) for k, v in got.items()
              if k != "render_process") == 0,
          "planning launched a rollout / update kernel")
    for row in p_info["history"]:
        check(0.0 <= row["success_rate"] <= 1.0,
              f"planning success_rate {row['success_rate']}")
    print(f"[train planning] peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)
    profile_epoch(p_trainer, p_ts, "planning",
                  groups={"render": ("render_process",),
                          "convs": CONV_WORDS})

    # ---- 14. render kernel timing ---------------------------------------------
    phase(14)
    inp = render_cases["planning 4096 guarded"]
    times["render_process"] = (
        cuda_time_ms(lambda: rc.render_process_packed(inp)),
        cuda_time_ms(lambda: rc.render_process_packed_plain(inp),
                     PLAIN_REPS),
        *render_bound(inp)[:2])
    k_ms, p_ms, b_ms, b_by = times["render_process"]
    live_mean = inp.live.to(torch.float32).mean(0).tolist()
    print(f"[time] render_process: kernel {k_ms:.3f} ms (parent "
          f"{PARENT_RENDER_MS['culled']}), plain {p_ms:.3f}, bound "
          f"{b_ms:.4f} by {b_by} (parent design's bound "
          f"{render_bound(inp)[2]:.4f}); records live per env "
          f"{[round(x, 3) for x in live_mean]}, cast per env "
          f"{cast_records(inp).float().mean(0).tolist()}", flush=True)
    # the same render unculled: every record in every env
    full = inp._replace(live=torch.tensor(
        inp.counts, dtype=torch.int32, device=dev)[None].repeat(
            inp.live.shape[0], 1))
    u_ms = cuda_time_ms(lambda: rc.render_process_packed(full))
    ub_ms, ub_by, uo_ms = render_bound(full)
    print(f"[time] render_process unculled: kernel {u_ms:.3f} ms (parent "
          f"{PARENT_RENDER_MS['unculled']}), bound {ub_ms:.4f} by {ub_by} "
          f"(parent design's bound {uo_ms:.4f}); records per env "
          f"{list(inp.counts)}", flush=True)
    box = render_cases["box 1024 unguarded"]
    bx_ms = cuda_time_ms(lambda: rc.render_process_packed(box))
    bb_ms, bb_by, bo_ms = render_bound(box)
    print(f"[time] render_process box 1024 unguarded: kernel {bx_ms:.3f} ms,"
          f" bound {bb_ms:.4f} by {bb_by} (parent design's bound "
          f"{bo_ms:.4f})", flush=True)
    del p_trainer, p_ts, full, render_cases
    torch.cuda.empty_cache()

    # ---- 15. the raw depth kernel vs its plain version ---------------------
    phase(15)
    depth_err, depth_cases = depth_checks(ra, rc, dev)

    # ---- 16. MAPlanning training at full width -----------------------------
    phase(16)
    reset_counts(kernels)
    torch.cuda.reset_peak_memory_stats()
    m_trainer, m_ts, m_info = train_and_reload(
        runner_mod, ckpt, load_cfg("maplanning"), "maplanning",
        MAPLANNING_EPOCHS, run_root, g, kernels)
    got = m_info["launches"]
    launches["render_depth"] = got["render_depth"].get("render_depth", 0)
    per_epoch = m_trainer.cfg.horizon // m_trainer.cam_every
    want = 1 + MAPLANNING_EPOCHS * per_epoch
    print(f"[train maplanning] {MAPLANNING_EPOCHS} epochs of "
          f"{m_trainer.num_envs} actors ({m_trainer.task.cfg.num_envs} envs "
          f"x {m_trainer.task.cfg.num_robots} robots), "
          f"{m_trainer.num_minibatches * m_trainer.cfg.mini_epochs} Adam "
          f"steps per epoch, in {m_info['train_s']:.2f} s; launches {got}",
          flush=True)
    check(m_trainer.num_envs == 16384 and m_trainer.frame_dedup,
          "maplanning must train 16,384 actors with frame dedup")
    check(launches["render_depth"] == want,
          f"maplanning raw depth launches {launches['render_depth']} != "
          f"{want} (1 at init + horizon / cam_every per epoch)")
    check(sum(sum(v.values()) for k, v in got.items()
              if k != "render_depth") == 0,
          "maplanning launched a render + process / rollout / update kernel")
    for row in m_info["history"]:
        for key in ("success_rate", "env_success_rate"):
            check(0.0 <= row[key] <= 1.0, f"maplanning {key} {row[key]}")
    print(f"[train maplanning] peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)
    profile_epoch(m_trainer, m_ts, "maplanning",
                  groups={"render_depth": ("render_depth",),
                          "convs": CONV_WORDS})
    del m_trainer, m_ts
    torch.cuda.empty_cache()

    # ---- 17. Avoid training --------------------------------------------------
    phase(17)
    reset_counts(kernels)
    a_trainer, a_ts, a_info = train_and_reload(
        runner_mod, ckpt, load_cfg("avoid"), "avoid", AVOID_EPOCHS, run_root,
        g, kernels)
    got = a_info["launches"]
    avoid_renders = got["render_process"].get("render_process", 0)
    want = 1 + AVOID_EPOCHS * (a_trainer.cfg.horizon // a_trainer.cam_every)
    print(f"[train avoid] {AVOID_EPOCHS} epochs in {a_info['train_s']:.2f} s;"
          f" launches {got}", flush=True)
    check(avoid_renders == want,
          f"avoid render launches {avoid_renders} != {want} (1 at init + "
          f"horizon / cam_every per epoch)")
    check(sum(sum(v.values()) for k, v in got.items()
              if k != "render_process") == 0,
          "avoid launched a raw depth / rollout / update kernel")
    for row in a_info["history"]:
        check(0.0 <= row["success_rate"] <= 1.0,
              f"avoid success_rate {row['success_rate']}")
    profile_epoch(a_trainer, a_ts, "avoid",
                  groups={"render": ("render_process",),
                          "convs": CONV_WORDS})
    del a_trainer, a_ts
    torch.cuda.empty_cache()

    # ---- 18. DepthGen generates a dataset ------------------------------------
    phase(18)
    out_dir = os.path.join(run_root, "depthgen_frames")
    shutil.rmtree(out_dir, ignore_errors=True)
    dg_task = envs.make_task("depthgen", num_envs=DEPTHGEN_ENVS, device=dev)
    reset_counts(kernels)
    t0 = time.time()
    saved = dg_task.generate(out_dir, DEPTHGEN_FRAMES, seed=7)
    torch.cuda.synchronize()
    gen_s = time.time() - t0
    dg_launches = dict(rc.DEPTH_KERNEL.launches)
    files = sorted(os.listdir(out_dir))
    print(f"[depthgen] {saved} frames of {DEPTHGEN_ENVS} envs in "
          f"{gen_s:.2f} s; launches {dg_launches}", flush=True)
    check(saved == len(files) == DEPTHGEN_FRAMES,
          f"depthgen wrote {len(files)} files for {saved} frames")
    check(dg_launches.get("render_depth", 0)
          == DEPTHGEN_FRAMES // DEPTHGEN_ENVS
          and sum(sum(k.launches.values()) for k in kernels)
          == dg_launches["render_depth"],
          f"depthgen launches {dg_launches} != "
          f"{DEPTHGEN_FRAMES // DEPTHGEN_ENVS} raw depth renders")
    lo, hi, blank = 1.0, 0.0, 0
    for name in files:
        img = np.load(os.path.join(out_dir, name))
        check(img.shape == (120, 212) and img.dtype == np.float32,
              f"depthgen frame {name}: {img.shape} {img.dtype}")
        check(bool(np.isfinite(img).all()), f"depthgen frame {name}: "
                                            f"not finite")
        lo, hi = min(lo, float(img.min())), max(hi, float(img.max()))
        blank += int(float(img.min()) == float(img.max()))
    print(f"[depthgen] frames [120, 212] float32, values in [{lo:.4f}, "
          f"{hi:.4f}], blank frames {blank}", flush=True)
    check(0.0 <= lo and hi <= 1.0 and blank == 0,
          "depthgen frames out of [0, 1] or blank")
    shutil.rmtree(out_dir, ignore_errors=True)

    # ---- 19. raw depth kernel timing -------------------------------------------
    phase(19)
    depth_times = {}
    for shape, d_inp in depth_cases.items():
        depth_times[shape] = (
            cuda_time_ms(lambda: rc.render_depth_packed(d_inp)),
            cuda_time_ms(lambda: rc.render_depth_packed_plain(d_inp),
                         PLAIN_REPS),
            *depth_bound(d_inp)[:2])
        k_ms, p_ms, b_ms, b_by = depth_times[shape]
        d_live = d_inp.live.to(torch.float32).mean(0).tolist()
        print(f"[time] render_depth {shape}: kernel {k_ms:.3f} ms (parent "
              f"{PARENT_DEPTH_MS[shape]}), plain {p_ms:.3f}, bound "
              f"{b_ms:.4f} by {b_by} (parent design's bound "
              f"{depth_bound(d_inp)[2]:.4f}); records live per env "
              f"{[round(x, 3) for x in d_live]}, cast per env "
              f"{cast_records(d_inp).float().mean(0).tolist()}", flush=True)
        render_split(ra, rc_clk["render_depth"], d_inp, shape)
    times["render_depth"] = depth_times["maplanning"]

    # ---- 20. the fused CNN kernels vs their plain versions ----------------
    phase(20)
    (cnn_fwd_err, cnn_bwd_err), cnn_case = cnn_checks(fc, dev)

    # ---- 21. Planning with cnn_impl='pallas' -------------------------------
    phase(21)
    reset_counts(kernels)
    torch.cuda.reset_peak_memory_stats()
    c_trainer, c_ts, c_info = train_and_reload(
        runner_mod, ckpt, load_cfg("planning"), "planning", PLANNING_EPOCHS,
        run_root, g, kernels, network_kw={"cnn_impl": "pallas"})
    got = c_info["launches"]
    check(c_ts.model.actor_cnn.impl == "pallas" and c_trainer.frame_dedup,
          "planning pallas: the trainer must run the fused CNN with frame "
          "dedup")
    steps = c_trainer.num_minibatches * c_trainer.cfg.mini_epochs
    renders = c_trainer.cfg.horizon // c_trainer.cam_every
    # per epoch: the rollout encodes its first frame, each rendered frame
    # and the bootstrap frame; every Adam step encodes its unique frames
    want = {"fused_cnn_fwd": PLANNING_EPOCHS * (renders + 2 + steps),
            "fused_cnn_bwd": PLANNING_EPOCHS * steps}
    for key, n in want.items():
        launches[key] = got["fused_cnn"].get(key, 0)
        check(launches[key] == n, f"planning pallas: {key} launches "
                                  f"{launches[key]} != {n}")
    c_renders = got["render_process"].get("render_process", 0)
    check(c_renders == 1 + PLANNING_EPOCHS * renders,
          f"planning pallas: render launches {c_renders} != "
          f"{1 + PLANNING_EPOCHS * renders}")
    check(sum(sum(v.values()) for k, v in got.items()
              if k not in ("fused_cnn", "render_process")) == 0,
          "planning pallas launched a rollout / update / raw depth kernel")
    for row in c_info["history"]:
        bad = [k for k, v in row.items() if not math.isfinite(v)]
        check(not bad, f"planning pallas epoch {row['epoch']}: {bad} not "
                       f"finite")
        check(0.0 <= row["success_rate"] <= 1.0,
              f"planning pallas success_rate {row['success_rate']}")
    print(f"[train planning pallas] {PLANNING_EPOCHS} epochs ({steps} Adam "
          f"steps each) in {c_info['train_s']:.2f} s; launches {got}",
          flush=True)
    print(f"[train planning pallas] peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)
    profile_epoch(c_trainer, c_ts, "planning pallas",
                  groups={"fused_cnn": ("fused_cnn",),
                          "render": ("render_process",),
                          "convs": CONV_WORDS}, forbid=CUDNN_WORDS)
    del c_trainer, c_ts
    torch.cuda.empty_cache()

    # ---- 22. fused CNN timing, the cuDNN stack beside it -------------------
    phase(22)
    x4, ws4 = cnn_case["fwd"]
    x6, ws6, dp6 = cnn_case["bwd"]
    times["fused_cnn_fwd"] = (
        cuda_time_ms(lambda: fc._fwd(x4, ws4)),
        cuda_time_ms(lambda: fc.encode_pooled_plain(x4, ws4), PLAIN_REPS),
        *cnn_bound(fc, x4, False))
    times["fused_cnn_bwd"] = (
        cuda_time_ms(lambda: fc._bwd(x6, ws6, dp6)),
        cuda_time_ms(lambda: fc.encode_pooled_plain_bwd(x6, ws6, dp6),
                     PLAIN_REPS),
        *cnn_bound(fc, x6, True))
    for key, x, bwd in (("fused_cnn_fwd", x4, False),
                        ("fused_cnn_bwd", x6, True)):
        k_ms, p_ms, b_ms, b_by = times[key]
        need = cnn_macs(*x.shape[1:])[int(bwd)]
        done = cnn_macs(*x.shape[1:], folded=True)[int(bwd)]
        print(f"[time] {key} B={x.shape[0]} bf16: kernel {k_ms:.3f} ms "
              f"(plain {p_ms:.3f}, bound {b_ms:.4f} by {b_by}; at the FP32 "
              f"peak {cnn_bound(fc, x, bwd, PEAK_FP32)[0]:.4f}); "
              f"{need / 1e6:.2f} M MACs per image needed, {done / 1e6:.2f} M "
              f"executed as folded products", flush=True)
    b_ms6 = times["fused_cnn_bwd"][0]
    work_b = fc.KERNEL.lib().fused_cnn_workspace_floats(212, 120, 1) * 4
    print(f"[time] fused_cnn_bwd B=609 bf16 on mma.sync: kernel {b_ms6:.3f} "
          f"ms beside {SCALAR_BWD_MS} ms of the scalar kernel it replaced "
          f"(same card type); bound {times['fused_cnn_bwd'][2]:.4f} "
          f"ms bf16, {cnn_bound(fc, x6, True, PEAK_FP32)[0]:.4f} ms FP32; "
          f"workspace {work_b} bytes per block x "
          f"{fc.KERNEL.lib().fused_cnn_bwd_blocks(609)} blocks", flush=True)
    fwd_ms = {4096: times["fused_cnn_fwd"][0],
              609: cuda_time_ms(lambda: fc._fwd(x6, ws6))}
    for b, x in ((4096, x4), (609, x6)):
        blocks = fc.KERNEL.lib().fused_cnn_fwd_blocks(b)
        work_f = fc.KERNEL.lib().fused_cnn_fwd_workspace_bytes(212, 120, 1)
        print(f"[time] fused_cnn_fwd B={b} bf16 on mma.sync: kernel "
              f"{fwd_ms[b]:.3f} ms beside {SCALAR_FWD_MS[b]} ms of the scalar "
              f"kernel it replaced (same card type); bound "
              f"{cnn_bound(fc, x, False)[0]:.4f} ms bf16, "
              f"{cnn_bound(fc, x, False, PEAK_FP32)[0]:.4f} ms FP32; a1 "
              f"workspace {work_f} bytes per block x {blocks} blocks",
              flush=True)
    # the encoders as the trainer calls them, fused and cuDNN (several
    # library calls: a yardstick, not library_ms)
    for impl in ("pallas", "auto"):
        enc = CNNEncoder(impl=impl, generator=torch.Generator()
                         .manual_seed(44)).to(dev)
        params = list(enc.parameters())
        img4, img6 = x4[:, None], x6[:, None]

        def fwd4():
            with torch.no_grad():
                enc(img4)

        def step6():
            torch.autograd.grad(enc(img6).sum(), params)

        print(f"[time] CNNEncoder(impl={impl!r}) bf16: forward B=4096 "
              f"{cuda_time_ms(fwd4, 5):.3f} ms, forward + backward B=609 "
              f"{cuda_time_ms(step6, 5):.3f} ms", flush=True)
        del enc, params

    # ---- 23. Hovering to the YAML's end, then played -------------------------
    phase(23)
    train_hovering_to_the_end(cli, fr, fu, kernels, run_root)

    # ---- 24. Balloon trained 200 epochs, evaluated as the reference was ------
    phase(24)
    train_and_eval_balloon(cli, runner_mod, fr, fu, kernels, run_root,
                           load_cfg("balloon"))

    # ---- 25. the Planning checkpoint played through the render kernel --------
    phase(25)
    play_planning(cli, rc, kernels, run_root,
                  p_info["checkpoint"][:-3] + ".pth",
                  int(p_yaml["params"]["config"]["horizon_length"]))

    # ---- 26. the control modes ------------------------------------------------
    phase(26)
    play_control_modes(cli, runner_mod, kernels, run_root, load_cfg("hovering"))
    print(f"[phases 23-26] done at {time.time() - T0:.1f} s", flush=True)

    # ---- 27. the model options: separate, state sigma, tanh -----------------
    phase(27)
    t27 = time.time()
    train_model_options(cli, kernels, run_root, load_cfg("hovering"), card)

    # ---- 28-29. Planning with a pretrained VAE / ResNet-18 encoder ----------
    for n, enc in ((28, "vae"), (29, "resnet")):
        phase(n)
        train_planning_encoder(runner_mod, ckpt, rc, kernels, run_root,
                               load_cfg("planning"), enc, card)
        torch.cuda.empty_cache()

    # ---- 30. the robot-count warm start -------------------------------------
    phase(30)
    warm_start_maplanning(runner_mod, ckpt, rc, kernels, run_root,
                          load_cfg("maplanning"), card)
    print(f"[phases 27-30] done at {time.time() - T0:.1f} s, "
          f"{time.time() - t27:.1f} s for the four", flush=True)

    # ---- 31-32. Customized at 212 x 120 and at 212 x 240 --------------------
    t31 = time.time()
    moments = {}
    for n, height in ((31, 120), (32, TALL_HEIGHT)):
        phase(n)
        moments[height], _ = train_customized(
            runner_mod, envs, rc, kernels, run_root, load_cfg("planning"),
            height, card)
    print(f"[train customized] image moments (mean, std): 212 x 120 "
          f"{moments[120]}, 212 x {TALL_HEIGHT} {moments[TALL_HEIGHT]}",
          flush=True)

    # ---- 33. multi-GPU ------------------------------------------------------
    phase(33)
    multi_gpu(runner_mod, run_root, load_cfg("hovering"),
              load_cfg("planning"), card)
    print(f"[phases 31-33] done at {time.time() - T0:.1f} s, "
          f"{time.time() - t31:.1f} s for the three", flush=True)

    # ---- 34-36. the native cascade, the library, the stream -----------------
    t34 = time.time()
    reset_counts(kernels)
    phase(34)
    native_cascade(card)
    phase(35)
    library_on_card(card)
    phase(36)
    stream_bridge(runner_mod, load_cfg("hovering"), hover_checkpoint, card)
    check(launched(kernels) == {}, f"phases 34-36 launched kernels: "
                                   f"{launched(kernels)}")
    print(f"[phases 34-36] done at {time.time() - T0:.1f} s, "
          f"{time.time() - t34:.1f} s for the three; no kernel launched",
          flush=True)

    def entry(name, key, source, replaces, err):
        k_ms, p_ms, b_ms, b_by = times[key]
        return {"name": name, "route": "cuda",
                "source": f"airgym_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": launches[key],
                "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}

    rollout_src = "airgym_tpu/ops/fused_rollout.py:105"
    update_src = "airgym_tpu/ops/fused_update.py:117"
    # no TPU kernel: XLA ops of the jitted epoch (GAE's lax.scan, the
    # running stats, the dataset)
    prep_src = "airgym_tpu/rl/ppo.py:503-529"
    kernels_line = {"kernels": [
        entry(f"fused_rollout[{t}]", t, "fused_rollout.cu", rollout_src,
              rollout_err[t]) for t in ("hovering", "balloon", "tracking")
    ] + [
        entry(f"fused_update[{o}]", o, "fused_update.cu", update_src,
              update_err[o]) for o in ("obs18", "obs48")
    ] + [
        entry(f"epoch_prep_{ph}[{o}]", f"prep_{ph}[{o}]", "epoch_prep.cu",
              prep_src, prep_err[o][ph])
        for o in ("obs18", "obs48") for ph in ep.PHASES
    ] + [
        entry("fused_hovering", "env", "fused_hovering.cu",
              "airgym_tpu/ops/fused_hovering.py:119",
              max(env_err, rew_err)),
        entry("render_process", "render_process", "render_process.cu",
              "airgym_tpu/render/pallas_raycast.py:530", render_err),
        entry("render_depth", "render_depth", "render_depth.cu",
              "airgym_tpu/render/pallas_raycast.py:366", depth_err),
        entry("fused_cnn_fwd", "fused_cnn_fwd", "fused_cnn.cu",
              "airgym_tpu/experiments/fused_cnn.py:238", cnn_fwd_err),
        entry("fused_cnn_bwd", "fused_cnn_bwd", "fused_cnn.cu",
              "airgym_tpu/experiments/fused_cnn.py:251", cnn_bwd_err),
    ]}
    print(json.dumps(kernels_line), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
