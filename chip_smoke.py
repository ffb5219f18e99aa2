#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (airgym_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:
  1. print the card's name and power limit (nvidia-smi);
  2. build every CUDA kernel from csrc/ with nvcc (one process per source,
     started together) and print each kernel's registers and spills;
  3. hold the Hovering rollout kernel against its plain PyTorch version at
     the main-path shape (4096 envs x 24 steps, obs noise on);
  4. hold the update kernel (18 features) against its plain version at
     the main-path shape (B = 98,304, minibatch 2048, 48 minibatches,
     5 mini-epochs);
  5. train the default Hovering PPO (configs/ppo_hovering.yaml, 4096
     envs) for a few epochs through the runner, with the kernels' launch
     counters set to 0 just before and read just after, then save and
     reload the checkpoint;
  6. time each kernel and its plain version with CUDA events;
  7. profile one steady epoch (device busy share, device time by kernel);
  8. hold the Balloon (4096 x 32) and Tracking (4096 x 24) rollout
     kernels against their plain versions, with resets, time-outs and
     balloon hits in the window, the update kernel at 18 features against
     its plain version at Balloon's shape (B = 131,072, 64 minibatches)
     and at 48 features at B = 98,304;
  9. hold the env-only Hovering kernel against its plain version at 4096
     envs x 64 steps with resets, then drive it once at 131,072 envs x 64
     (counters set to 0 before, read after) and hold that run against the
     plain version too;
 10. train Balloon (configs/ppo_balloon.yaml at 4096 envs) and Tracking
     (configs/ppo_tracking.yaml) for 3 epochs each through the runner,
     counters checked (Balloon: 1 rollout + 640 update launches per epoch,
     Tracking: 1 + 480), save and reload each, and profile one epoch each;
 11. time the new kernels and their plain versions;
 12. hold the fused render + post-process kernel against its plain
     version: at Planning's full shape (4096 envs, 212 x 120, 40 trees, a
     goal ball and the ground, culled at 4.5 m, after some env steps), on
     a one-box scene like Avoid's (too small to cull: the unguarded
     chain) and on a 256-env scene of all four record kinds;
 13. train Planning (configs/ppo_planning.yaml, 4096 envs) for 3 epochs
     through the runner with the render counter set to 0 before and read
     after (1 launch at init, 6 per epoch), save and reload the
     checkpoint, and profile one epoch (render, convs, the rest);
 14. time the render kernel and its plain version, and print one JSON
     line listing every ported kernel.
The last line is {"ok": true, "device": {...}}. Imports nothing of JAX.
"""
import json
import math
import os
import statistics
import subprocess
import sys
import time

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
ENV_N, ENV_STEPS = 131072, 64   # env-only kernel: main-path run and timing

# H100 SXM: 67 TFLOP/s FP32 outside the tensor cores, 3.35 TB/s HBM3
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
# FP32 operations of one env-only step per env, counted by hand from
# csrc/quad_step.cuh (each division, square root and transcendental as
# one; the hash's integer work not counted): controller ~140, physics
# ~180, hovering reward ~150, reset float math ~110
ENV_STEP_OPS = 580
# FP32 operations of the render kernel, counted by hand from
# csrc/raycast.cuh and csrc/render_process.cu (each division and square
# root as one; the hash's integer work not counted): per pixel the ray and
# the ground ~37 and the post-processing ~80, per pixel and record a
# cylinder ~58, a sphere ~20, a box ~45, an annulus ~90
RENDER_PIXEL_OPS = 37 + 80
RENDER_RECORD_OPS = (58, 20, 45, 90)
RENDER_ATOL = 1e-5              # the JAX suite's (tests/test_fused_render.py)
PLANNING_EPOCHS = 3


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


def bound_ms(flops, nbytes):
    t_ops, t_bytes = flops / PEAK_FP32, nbytes / PEAK_BYTES
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
    out_p, rec_p = fr.rollout_fused_policy_plain(packed, pack, seed, steps,
                                                 obs_noise=True, task=task,
                                                 motor_alpha=alpha)
    torch.cuda.synchronize()
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
          f"{n_reset} timeouts {n_timeout} hits {n_hit}", flush=True)
    check(err_rec <= ROLLOUT_ATOL and err_st <= ROLLOUT_ATOL,
          f"{task} rollout kernel disagrees with its plain version beyond "
          f"atol {ROLLOUT_ATOL}")
    return max(err_rec, err_st), n_reset, n_timeout, n_hit


def env_vs_plain(fh, packed, act, seed, steps, out_k, rew_k):
    """The env-only kernel's result (out_k, rew_k) vs its plain version on
    the same inputs; returns (max state err, max reward-sum err)."""
    out_p, rew_p = fh.rollout_fused_plain(packed, act, seed, steps)
    torch.cuda.synchronize()
    n = packed.shape[1]
    check(torch.equal(out_k[19:21], out_p[19:21]),
          f"env-only kernel at {n}x{steps}: progress / reset flags differ "
          f"from plain")
    env_err = float((out_k[:29] - out_p[:29]).abs().max())
    rew_err = float((rew_k - rew_p).abs().max())
    n_fresh = int((out_p[19] < steps).sum())
    print(f"[env-only] {n}x{steps}: max|state err| {env_err:.3e} "
          f"max|reward-sum err| {rew_err:.3e} envs reset in the window "
          f"{n_fresh}", flush=True)
    check(n_fresh > 0, f"env-only window at {n}x{steps} has no resets")
    check(env_err <= ENV_STATE_ATOL and rew_err <= ENV_REWARD_ATOL,
          f"env-only kernel disagrees with its plain version at {n}x{steps}")
    check(torch.equal(out_k[29:], packed[29:]),
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
    res_p = fu.fused_update_plain(*args, **kw)
    torch.cuda.synchronize()
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
    print(f"[update {tag}] B={B} mb={B // kw['nmb']} nmb={kw['nmb']} "
          f"mini_epochs={kw['mini_epochs']}: max|param err| "
          f"{update_err:.3e} lr {float(res_k[3]):.3e} count "
          f"{float(res_k[4]):.0f} kl {float(res_k[5]['kl']):.3e}",
          flush=True)
    return update_err


def train_and_reload(runner_mod, ckpt, yaml_cfg, task, epochs, run_root,
                     probe_gen, kernels, num_envs=None):
    """Train through the runner; save / reload the native checkpoint and
    the reference .pth. Returns (a trainer of the run's config, the run's
    TrainState, the run info)."""
    params = yaml_cfg["params"]
    params["config"]["max_epochs"] = epochs
    params["config"]["save_best_after"] = 1
    params["seed"] = 42
    runner = runner_mod.Runner().load(yaml_cfg)
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
              + (f" success_rate {row['success_rate']:.4f}"
                 if "success_rate" in row else ""), flush=True)
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


def profile_epoch(trainer, ts, tag, groups=None):
    """One warm epoch, then one under torch.profiler: wall, device busy,
    the top kernels by device time. The profiler slows the host, so the
    busy time is also set against the warm epoch's own wall."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ts_prof = trainer.train_epoch(ts)[0]               # warm
    torch.cuda.synchronize()
    warm_ms = 1e3 * (time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.train_epoch(ts_prof)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    # the device's own events (kernels, copies, memsets) only: an aten
    # op's self device time repeats the kernels it launched, and summing
    # both would count that time twice
    cpu = torch.autograd.DeviceType.CPU
    rows, op_rows = [], []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        if us > 0:
            on_device = getattr(e, "device_type", cpu) != cpu
            (rows if on_device else op_rows).append(
                (us / 1e3, e.count, e.key))
    if not rows:
        # this torch tags no event with a device: the aten ops' self device
        # time is all there is, and it counts some kernels twice
        print(f"[profile {tag}] WARNING: no device-typed profiler events; "
              f"the busy time below sums aten ops' self device time and may "
              f"count a kernel twice", flush=True)
        rows, op_rows = op_rows, []
    rows.sort(reverse=True)
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


def render_bound(inp, live_mean):
    """(bound ms, what bounds it) of one render: the operations of the
    records that survive culling (their mean per env), the bytes of the
    inputs read once and the image written once."""
    n = inp.origins.shape[0]
    pix = n * inp.cfg.width * inp.cfg.height
    ops = pix * (RENDER_PIXEL_OPS + sum(
        c * k for c, k in zip(live_mean, RENDER_RECORD_OPS)))
    nbytes = sum(x.numel() * x.element_size() for x in (
        inp.origins, inp.rots, inp.prims, inp.live, inp.taps))
    nbytes += 4 * n + 4 * pix                # seeds as uint32, the image
    return bound_ms(ops, nbytes)


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


def render_checks(envs, rc, dev):
    """Phase 12: the render kernel at Planning's full shape (guarded),
    on a box scene (unguarded) and on a scene of all four kinds.
    Returns (max error, (Planning's inputs, their live records per env))."""
    from airgym_tpu_torch.physics import scene as sc
    from airgym_tpu_torch.render import depth as dr
    task = envs.make_task("planning", num_envs=4096, device=dev)
    g = torch.Generator(device=dev).manual_seed(21)
    st = task.initial_state(g)
    for _ in range(30):                        # the drones move and turn
        a = torch.rand((4096, 4), generator=g, device=dev) * 1.2 - 0.6
        a[:, 3] = -0.69 + 0.1 * a[:, 3]
        st, _ = task.step(st, a, g, render=False)
    root = st.core.root
    inp = rc.prepare(task.cam_cfg, root, task.scene(st), 987654321,
                     task.cam_cfg.depth_clamp)
    check(inp.prims.shape[1] == 48 and inp.counts == (40, 1, 0, 0),
          f"planning scene packs as {inp.counts} in {inp.prims.shape[1]}")
    err_p, live = render_vs_plain(rc, inp, "planning 4096 guarded")

    rng = torch.Generator(device=dev).manual_seed(22)
    u = lambda *shape: torch.rand(shape, generator=rng, device=dev)
    n = 1024
    box_root = root[:n].clone()
    box_root[:, 0:3] = torch.stack([u(n) - 0.5, u(n) - 0.5, 0.8 + 0.4 * u(n)],
                                   dim=-1)
    box = sc.Boxes(center=torch.stack([2.0 + 2.0 * u(n), 2.0 * u(n) - 1.0,
                                       0.3 + u(n)], dim=-1)[:, None],
                   yaw=(6.0 * u(n) - 3.0)[:, None],
                   half_extents=(0.2 + 0.3 * u(n, 1, 3)),
                   valid=torch.ones((n, 1), dtype=torch.bool, device=dev))
    inp_b = rc.prepare(task.cam_cfg, box_root,
                       dr.SceneForRender(boxes=box, ground=True), 5, 4.5)
    check(inp_b.prims.shape[1] == 8 and
          bool((inp_b.live == torch.tensor([0, 0, 1, 0], device=dev)).all()),
          "the box scene must run unguarded")
    err_b, _ = render_vs_plain(rc, inp_b, "box 1024 unguarded")

    n = 256
    mix_root = root[:n].clone()
    mix_root[:, 0:3] = torch.tensor([0.0, 0.0, 1.0], device=dev)
    unit = lambda x: x / x.norm(dim=-1, keepdim=True)
    cyl = sc.Cylinders(
        center=torch.stack([9 * u(n, 20) - 3, 4 * u(n, 20) - 2,
                            torch.full((n, 20), 1.2, device=dev)], -1),
        axis=unit(torch.cat([0.6 * u(n, 20, 2) - 0.3,
                             torch.ones((n, 20, 1), device=dev)], -1)),
        half_len=0.8 + 0.8 * u(n, 20), radius=0.05 + 0.35 * u(n, 20),
        valid=u(n, 20) > 0.1)
    sph = sc.Spheres(center=torch.stack([0.5 + 3.5 * u(n, 3), 2 * u(n, 3) - 1,
                                         0.6 + 0.8 * u(n, 3)], -1),
                     radius=0.1 + 0.3 * u(n, 3),
                     valid=torch.ones((n, 3), dtype=torch.bool, device=dev))
    boxes = sc.Boxes(center=torch.stack([1 + 3 * u(n, 3), 3 * u(n, 3) - 1.5,
                                         0.3 + 1.2 * u(n, 3)], -1),
                     yaw=6 * u(n, 3) - 3, half_extents=0.1 + 0.4 * u(n, 3, 3),
                     valid=torch.ones((n, 3), dtype=torch.bool, device=dev))
    ann = sc.Annuli(center=torch.stack([1.5 + 2 * u(n, 3), 1.6 * u(n, 3) - 0.8,
                                        0.8 + 0.4 * u(n, 3)], -1),
                    normal=unit(torch.cat([torch.ones((n, 3, 1), device=dev),
                                           0.8 * u(n, 3, 2) - 0.4], -1)),
                    r_in=0.2 + 0.2 * u(n, 3), r_out=0.5 + 0.3 * u(n, 3),
                    half_thick=0.02 + 0.08 * u(n, 3),
                    valid=torch.ones((n, 3), dtype=torch.bool, device=dev))
    inp_m = rc.prepare(task.cam_cfg, mix_root, dr.SceneForRender(
        cylinders=cyl, spheres=sph, boxes=boxes, annuli=ann, ground=True),
        77, 4.5)
    err_m, _ = render_vs_plain(rc, inp_m, "mixed 256 guarded")
    return max(err_p, err_b, err_m), (inp, live)


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a GPU")

    from airgym_tpu_torch import envs
    from airgym_tpu_torch.kernels import build
    from airgym_tpu_torch.models.actor_critic import ActorCritic
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
    kernels = [fr.KERNEL, fu.KERNEL, fh.KERNEL, rc.KERNEL]
    secs = build.build_all(kernels)
    print(f"[build] {len(kernels)} kernels in {secs:.1f} s", flush=True)
    for k in kernels:
        for line in k.build_log.splitlines():
            if ("registers" in line or "spill" in line or "error" in line
                    or "Compiling entry" in line):
                print(f"[build] {k.name}: {line.strip()}", flush=True)
    print(f"[build] render_process: dynamic shared memory "
          f"{rc.KERNEL.lib().render_process_smem_bytes(48, 212, 120)} bytes "
          f"per block at 212 x 120 with 48 records", flush=True)

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
    g = torch.Generator(device=dev)
    g.manual_seed(7)
    B = trainer.batch_size
    nmb, me = trainer.num_minibatches, pcfg.mini_epochs
    upd_args, upd_kw = update_case(fu, ts.model, ts.obs_rms, g, B, 18,
                                   ts.lr, pcfg, nmb)
    update_err = {"obs18": update_vs_plain(fu, upd_args, upd_kw, "obs18")}

    # ---- 5. train through the runner --------------------------------------
    reset_counts(kernels)
    _, ts_run, info = train_and_reload(runner_mod, ckpt, yaml_cfg,
                                       "hovering", EPOCHS, run_root, g,
                                       kernels)
    launches = {"hovering": fr.KERNEL.launches["hovering"],
                "obs18": fu.KERNEL.launches["obs18"]}
    per_epoch_update = 2 * nmb * me
    print(f"[train hovering] {EPOCHS} epochs in {info['train_s']:.2f} s; "
          f"launches {launches}", flush=True)
    check(launches["hovering"] == EPOCHS,
          f"rollout kernel launches {launches['hovering']} != "
          f"{EPOCHS} (1 per epoch)")
    check(launches["obs18"] == EPOCHS * per_epoch_update,
          f"update kernel launches {launches['obs18']} != "
          f"{EPOCHS * per_epoch_update} ({per_epoch_update} per epoch)")

    # ---- 6. timing ----------------------------------------------------------
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
    for key in ("hovering", "obs18"):
        k_ms, p_ms, b_ms, b_by = times[key]
        print(f"[time] {key}: kernel {k_ms:.3f} ms (plain {p_ms:.3f}, "
              f"bound {b_ms:.4f} by {b_by})", flush=True)

    # ---- 7. where one epoch's time goes (torch.profiler) --------------------
    profile_epoch(trainer, ts_run, "hovering")

    # ---- 8. Balloon / Tracking rollouts, the update at 48 features ---------
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
            # minibatches (640 launches per epoch)
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
    act = torch.tensor([0.05, -0.05, 0.02, 0.4], device=dev)
    e_task = envs.make_task("hovering", ctl_mode="rate", num_envs=n_envs,
                            device=dev)
    e_packed = fh.pack_state(e_task.initial_state(
        torch.Generator(device=dev).manual_seed(13)).core)
    e_packed[19, :256] = 2380.0
    out_k, rew_k = fh.rollout_fused(e_packed, act, 99, 64)
    env_err, rew_err = env_vs_plain(fh, e_packed, act, 99, 64, out_k, rew_k)
    big_task = envs.make_task("hovering", ctl_mode="rate", num_envs=ENV_N,
                              device=dev)
    big = fh.pack_state(big_task.initial_state(
        torch.Generator(device=dev).manual_seed(17)).core)
    big[19, :256] = 2380.0
    reset_counts(kernels)
    out_big, rew_big = fh.rollout_fused(big, act, 5, ENV_STEPS)
    torch.cuda.synchronize()
    launches["env"] = fh.KERNEL.launches["env"]
    check(launches["env"] == 1 and sum(fr.KERNEL.launches.values()) == 0,
          f"env-only path launches {launches['env']} != 1")
    check(bool(torch.isfinite(out_big[:29]).all())
          and bool(torch.isfinite(rew_big).all()),
          "env-only run at full size is not finite")
    qn = out_big[3:7].norm(dim=0)
    check(float((qn - 1.0).abs().max()) < 1e-3, "env-only: quats not unit")
    # the main path's own launch against the plain version at its shape
    big_errs = env_vs_plain(fh, big, act, 5, ENV_STEPS, out_big, rew_big)
    env_err, rew_err = max(env_err, big_errs[0]), max(rew_err, big_errs[1])

    # ---- 10. Balloon and Tracking training ------------------------------------
    paths = {"balloon": ("balloon", "obs18", 640),
             "tracking": ("tracking", "obs48", 480)}
    for name, (rkey, ukey, per_epoch) in paths.items():
        reset_counts(kernels)
        t_trainer, t_ts, t_info = train_and_reload(
            runner_mod, ckpt, load_cfg(name), name, TASK_EPOCHS, run_root, g,
            kernels, num_envs=n_envs)
        got = {rkey: fr.KERNEL.launches[rkey], ukey: fu.KERNEL.launches[ukey]}
        print(f"[train {name}] {TASK_EPOCHS} epochs in "
              f"{t_info['train_s']:.2f} s; launches {got}", flush=True)
        check(got[rkey] == TASK_EPOCHS,
              f"{name} rollout launches {got[rkey]} != {TASK_EPOCHS}")
        check(got[ukey] == TASK_EPOCHS * per_epoch,
              f"{name} update launches {got[ukey]} != "
              f"{TASK_EPOCHS * per_epoch} ({per_epoch} per epoch)")
        check(t_trainer.num_minibatches * 2 * t_trainer.cfg.mini_epochs
              == per_epoch, f"{name}: unexpected minibatch count")
        launches[rkey] = got[rkey]
        if ukey not in launches:
            launches[ukey] = got[ukey]
        if name == "balloon":
            for row in t_info["history"]:
                check(0.0 <= row["success_rate"] <= 1.0,
                      f"balloon success_rate {row['success_rate']}")
        profile_epoch(t_trainer, t_ts, name)

    # ---- 11. timing of the new kernels, the kernels line ------------------------
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
    times["env"] = (
        cuda_time_ms(lambda: fh.rollout_fused(big, act, 5, ENV_STEPS)),
        cuda_time_ms(lambda: fh.rollout_fused_plain(big, act, 5, ENV_STEPS),
                     PLAIN_REPS),
        *bound_ms(ENV_STEP_OPS * ENV_N * ENV_STEPS,
                  4.0 * (2 * fh._F * ENV_N + ENV_N + 4)))
    for key in ("balloon", "tracking", "obs48", "env"):
        k_ms, p_ms, b_ms, b_by = times[key]
        print(f"[time] {key}: kernel {k_ms:.3f} ms (plain {p_ms:.3f}, "
              f"bound {b_ms:.4f} by {b_by})", flush=True)

    # ---- 12. the render + post-process kernel vs its plain version ---------
    render_err, render_case = render_checks(envs, rc, dev)

    # ---- 13. Planning training -----------------------------------------------
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
                          "convs": ("conv", "cudnn", "implicit", "wgrad",
                                    "dgrad", "fprop", "winograd", "nchw",
                                    "nhwc", "im2col")})

    # ---- 14. render kernel timing ---------------------------------------------
    inp, live_mean = render_case
    times["render_process"] = (
        cuda_time_ms(lambda: rc.render_process_packed(inp)),
        cuda_time_ms(lambda: rc.render_process_packed_plain(inp),
                     PLAIN_REPS),
        *render_bound(inp, live_mean))
    k_ms, p_ms, b_ms, b_by = times["render_process"]
    print(f"[time] render_process: kernel {k_ms:.3f} ms (plain {p_ms:.3f}, "
          f"bound {b_ms:.4f} by {b_by}; records live per env "
          f"{[round(x, 3) for x in live_mean]})", flush=True)
    # the same render unculled: every record in every env
    full = inp._replace(live=torch.tensor(
        inp.counts, dtype=torch.int32, device=dev)[None].repeat(
            inp.live.shape[0], 1))
    u_ms = cuda_time_ms(lambda: rc.render_process_packed(full))
    ub_ms, ub_by = render_bound(full, list(inp.counts))
    print(f"[time] render_process unculled: kernel {u_ms:.3f} ms (bound "
          f"{ub_ms:.4f} by {ub_by}; records per env {list(inp.counts)})",
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
    kernels_line = {"kernels": [
        entry(f"fused_rollout[{t}]", t, "fused_rollout.cu", rollout_src,
              rollout_err[t]) for t in ("hovering", "balloon", "tracking")
    ] + [
        entry(f"fused_update[{o}]", o, "fused_update.cu", update_src,
              update_err[o]) for o in ("obs18", "obs48")
    ] + [
        entry("fused_hovering", "env", "fused_hovering.cu",
              "airgym_tpu/ops/fused_hovering.py:119",
              max(env_err, rew_err)),
        entry("render_process", "render_process", "render_process.cu",
              "airgym_tpu/render/pallas_raycast.py:530", render_err),
    ]}
    print(json.dumps(kernels_line), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
