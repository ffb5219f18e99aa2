#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (airgym_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:
  1. print the card's name and power limit (nvidia-smi);
  2. build every CUDA kernel of the default trainer from csrc/ with nvcc
     (one process per source, started together);
  3. hold the fused rollout kernel against its plain PyTorch version at
     the main-path shape (4096 envs x 24 steps, obs noise on);
  4. hold the fused update kernel against its plain version at the
     main-path shape (B = 98,304, minibatch 2048, 48 minibatches,
     5 mini-epochs);
  5. train the default Hovering PPO (configs/ppo_hovering.yaml, 4096
     envs) for a few epochs through the runner, with the kernels' launch
     counters set to 0 just before and read just after, then save and
     reload the checkpoint;
  6. time each kernel and its plain version with CUDA events (median of
     20);
  7. profile one steady epoch (device busy share, device time by
     kernel) and print one JSON line listing every ported kernel.
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
# are those of the JAX suite's fused-update tests
ROLLOUT_ATOL = 1e-4
UPDATE_PARAM_RTOL = 2e-3        # of max |ref| per tensor, + 1e-5
METRIC_RTOL, METRIC_ATOL = 5e-3, 5e-4
EPOCHS = 4
TIMING_REPS = 20

# H100 SXM: 67 TFLOP/s FP32 outside the tensor cores, 3.35 TB/s HBM3
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12


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


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a GPU")

    from airgym_tpu_torch import envs
    from airgym_tpu_torch.kernels import build
    from airgym_tpu_torch.ops import fused_hovering as fh
    from airgym_tpu_torch.ops import fused_rollout as fr
    from airgym_tpu_torch.ops import fused_update as fu
    from airgym_tpu_torch.rl import checkpoint as ckpt
    from airgym_tpu_torch.rl import runner as runner_mod
    from airgym_tpu_torch.rl.fused_ppo import FusedHoveringPPO
    from airgym_tpu_torch.rl.runner import ppo_config_from_params
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
    kernels = [fr.KERNEL, fu.KERNEL]
    secs = build.build_all(kernels)
    print(f"[build] {len(kernels)} kernels in {secs:.1f} s", flush=True)
    for k in kernels:
        for line in k.build_log.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print(f"[build] {k.name}: {line.strip()}", flush=True)

    cfg_path = os.path.join(os.path.dirname(os.path.abspath(fr.__file__)),
                            "..", "configs", "ppo_hovering.yaml")
    with open(cfg_path) as f:
        yaml_cfg = yaml.safe_load(f)
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
    rollout_err = 0.0
    for alpha in (0.0, 0.6):
        out_k, rec_k = fr.rollout_fused_policy(packed, pack, seed, H,
                                               obs_noise=True,
                                               motor_alpha=alpha)
        out_p, rec_p = fr.rollout_fused_policy_plain(packed, pack, seed, H,
                                                     obs_noise=True,
                                                     motor_alpha=alpha)
        torch.cuda.synchronize()
        flags_k, flags_p = rec_k[:, 29:31], rec_p[:, 29:31]
        check(torch.equal(flags_k, flags_p),
              f"rollout done/timeout flags differ (alpha={alpha}): "
              f"{int((flags_k != flags_p).sum())} of {flags_k.numel()}")
        check(bool(torch.isfinite(rec_k).all()), "rollout record not finite")
        err_rec = float((rec_k[:, :29] - rec_p[:, :29]).abs().max())
        err_st = float((out_k[:29] - out_p[:29]).abs().max())
        n_reset = int(flags_p[:, 0].sum())
        n_timeout = int(flags_p[:, 1].sum())
        print(f"[rollout] alpha={alpha} {n_envs}x{H}: max|rec err| "
              f"{err_rec:.3e} max|state err| {err_st:.3e} resets "
              f"{n_reset} timeouts {n_timeout}", flush=True)
        check(err_rec <= ROLLOUT_ATOL and err_st <= ROLLOUT_ATOL,
              f"rollout kernel disagrees with its plain version beyond "
              f"atol {ROLLOUT_ATOL}")
        if alpha == 0.0:
            rollout_err = max(err_rec, err_st)

    # ---- 4. update kernel vs plain ----------------------------------------
    g = torch.Generator(device=dev)
    g.manual_seed(7)
    B = trainer.batch_size
    nmb, me = trainer.num_minibatches, pcfg.mini_epochs
    obs = torch.randn((B, fr.OBS), generator=g, device=dev)
    with torch.no_grad():
        mu0, sigma, _ = ts.model(obs, ts.obs_rms)
    logstd = ts.model.logstd.detach()
    actions = mu0 + sigma * torch.randn(mu0.shape, generator=g, device=dev)
    d = (actions - mu0) / sigma
    nlp = (0.5 * (d * d).sum(-1) + 0.5 * math.log(2 * math.pi) * 4
           + logstd.sum())
    adv = torch.randn((B,), generator=g, device=dev)
    ret = torch.randn((B,), generator=g, device=dev)
    obs_n = ts.obs_rms.normalize(obs)
    named = dict(ts.model.named_parameters())
    kcfg = dict(e_clip=pcfg.e_clip, critic_coef=pcfg.critic_coef,
                bounds_coef=pcfg.bounds_loss_coef,
                entropy_coef=pcfg.entropy_coef,
                truncate_grads=pcfg.truncate_grads, grad_norm=pcfg.grad_norm,
                adaptive_lr=True, kl_threshold=pcfg.kl_threshold,
                min_lr=pcfg.min_lr, max_lr=pcfg.max_lr)
    upd_args = (obs_n, actions, adv, ret, nlp, mu0,
                torch.exp(logstd).reshape(-1, 1), fu.pack_update(named),
                fu.pack_update(ts.adam["m"]), fu.pack_update(ts.adam["v"]),
                ts.lr.reshape(1), ts.adam["count"].reshape(1))
    upd_kw = dict(nmb=nmb, mini_epochs=me, cfg=kcfg)
    res_k = fu.fused_update(*upd_args, **upd_kw)
    res_p = fu.fused_update_plain(*upd_args, **upd_kw)
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
                  f"update {which}.{f}: max|err| {err:.3e} vs scale "
                  f"{scale:.3e}")
    check(math.isclose(float(res_k[3]), float(res_p[3]), rel_tol=1e-6),
          f"update lr {float(res_k[3])} vs {float(res_p[3])}")
    check(float(res_k[4]) == float(res_p[4]),
          f"update count {float(res_k[4])} vs {float(res_p[4])}")
    for key in fu.METRICS:
        a, b = float(res_p[5][key]), float(res_k[5][key])
        check(math.isfinite(b) and abs(a - b) <= METRIC_ATOL
              + METRIC_RTOL * abs(a),
              f"update metric {key}: kernel {b} vs plain {a}")
    print(f"[update] B={B} mb={B // nmb} nmb={nmb} mini_epochs={me}: "
          f"max|param err| {update_err:.3e} lr {float(res_k[3]):.3e} "
          f"count {float(res_k[4]):.0f} kl {float(res_k[5]['kl']):.3e}",
          flush=True)

    # ---- 5. train through the runner --------------------------------------
    params["config"]["max_epochs"] = EPOCHS
    params["config"]["save_best_after"] = 1
    params["seed"] = 42
    run_root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "build", "chip_smoke_runs")
    for k in kernels:
        k.launches = 0
    t0 = time.time()
    ts_run, info = runner_mod.Runner().load(yaml_cfg).run_train(
        {"task": "hovering", "ctl_mode": "rate", "device": "cuda",
         "run_root": run_root, "log_every": 1})
    torch.cuda.synchronize()
    train_s = time.time() - t0
    launches = {k.name: k.launches for k in kernels}
    per_epoch_update = 2 * nmb * me
    print(f"[train] {EPOCHS} epochs in {train_s:.2f} s; launches "
          f"{launches}", flush=True)
    for row in info["history"]:
        print(f"[train] epoch {row['epoch']}: mean_reward "
              f"{row['mean_reward']:.4f} loss {row['loss']:.5f} kl "
              f"{row['kl']:.3e} lr {row['lr']:.3e} epoch_s "
              f"{row['seconds']:.3f} fps {row['fps']:.0f}", flush=True)
        for key in ("mean_reward", "loss", "kl", "lr", "seconds"):
            check(math.isfinite(row[key]), f"epoch {row['epoch']}: {key} "
                                           f"not finite")
    check(len(info["history"]) == EPOCHS, "missing epochs in the history")
    check(launches["fused_rollout"] == EPOCHS,
          f"rollout kernel launches {launches['fused_rollout']} != "
          f"{EPOCHS} (1 per epoch)")
    check(launches["fused_update"] == EPOCHS * per_epoch_update,
          f"update kernel launches {launches['fused_update']} != "
          f"{EPOCHS * per_epoch_update} ({per_epoch_update} per epoch)")

    # save / reload: native checkpoint and the reference .pth
    ts_new = trainer.init(5)
    ts_new = ckpt.restore(ts_new, ckpt.load(info["checkpoint"]))
    for name, p in ts_run.model.state_dict().items():
        check(torch.equal(p, ts_new.model.state_dict()[name]),
              f"checkpoint reload differs at {name}")
    check(torch.equal(ts_new.adam["count"], ts_run.adam["count"]),
          "checkpoint reload: Adam count differs")
    model2 = trainer.make_model()
    ckpt.import_pth(info["checkpoint"][:-3] + ".pth", model2)
    probe = torch.randn((64, fr.OBS), generator=g, device=dev)
    with torch.no_grad():
        mu_a, _, v_a = ts_run.model(probe)
        mu_b, _, v_b = model2(probe)
    check(torch.equal(mu_a, mu_b) and torch.equal(v_a, v_b),
          ".pth reload gives another mu / value")
    print(f"[train] checkpoint {os.path.basename(info['checkpoint'])} "
          f"saved and reloaded (native + .pth)", flush=True)

    # ---- 6. timing ----------------------------------------------------------
    n, steps = packed.shape[1], H
    rollout_flops = 2.0 * 17856 * n * steps
    rollout_bytes = 4.0 * (2 * fr._F * n + steps * fr.REC * n
                           + fr.flat_policy(pack).numel())
    r_bound, r_by = bound_ms(rollout_flops, rollout_bytes)
    r_ms = cuda_time_ms(lambda: fr.rollout_fused_policy(packed, pack, seed,
                                                        steps))
    r_plain = cuda_time_ms(lambda: fr.rollout_fused_policy_plain(
        packed, pack, seed, steps))
    per_sample = 2.0 * (17856 + 17856 + 16704)
    update_flops = per_sample * B * me
    update_bytes = 4.0 * (B * (fr.OBS + 4 + 3 + 4) + 6 * fu.NP)
    u_bound, u_by = bound_ms(update_flops, update_bytes)
    u_ms = cuda_time_ms(lambda: fu.fused_update(*upd_args, **upd_kw))
    u_plain = cuda_time_ms(lambda: fu.fused_update_plain(*upd_args,
                                                         **upd_kw))
    print(f"[time] rollout {r_ms:.3f} ms (plain {r_plain:.3f}, bound "
          f"{r_bound:.4f} by {r_by}); update {u_ms:.3f} ms (plain "
          f"{u_plain:.3f}, bound {u_bound:.4f} by {u_by})", flush=True)

    # ---- 7. where one epoch's time goes (torch.profiler) --------------------
    from torch.profiler import ProfilerActivity, profile
    ts_prof = trainer.train_epoch(ts_run)[0]          # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.train_epoch(ts_prof)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        if us > 0:
            rows.append((us / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows)
    print(f"[profile] one epoch: wall {wall_ms:.2f} ms, device busy "
          f"{busy_ms:.2f} ms ({100 * busy_ms / wall_ms:.1f}%) under the "
          f"profiler", flush=True)
    for ms, count, key in rows[:8]:
        print(f"[profile]   {ms:8.3f} ms  x{count:<5d} {key[:70]}",
              flush=True)

    kernels_line = {"kernels": [
        {"name": "fused_rollout", "route": "cuda",
         "source": "airgym_tpu_torch/csrc/fused_rollout.cu",
         "replaces": "airgym_tpu/ops/fused_rollout.py:105",
         "launches": launches["fused_rollout"],
         "max_abs_err": rollout_err, "ms": r_ms, "plain_ms": r_plain,
         "bound_ms": r_bound, "bound_by": r_by, "library_ms": None},
        {"name": "fused_update", "route": "cuda",
         "source": "airgym_tpu_torch/csrc/fused_update.cu",
         "replaces": "airgym_tpu/ops/fused_update.py:117",
         "launches": launches["fused_update"],
         "max_abs_err": update_err, "ms": u_ms, "plain_ms": u_plain,
         "bound_ms": u_bound, "bound_by": u_by, "library_ms": None},
    ]}
    print(json.dumps(kernels_line), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
