"""Multi-GPU training over torch.distributed (counterpart of
airgym_tpu/parallel/mesh.py).

The JAX package shards the env axis of one program over a device mesh,
and XLA computes the unsharded program. The port keeps that semantics
with one process per GPU (a "rank"):

  * each rank steps one contiguous block of the envs (``env_shard``): its
    task draws every random number of the whole batch and keeps its rows
    (``envs.base.QuadEnvCore.shard``), and the fused rollout kernel's seed
    is offset by the rank's tiles, so the ranks' rollouts are the
    unsharded rollout's rows;
  * after the rollout every rank gathers the whole batch
    (``all_gather_cat``), so GAE, the running stats and the advantage
    normalisation run as on one GPU;
  * each rank takes an equal part of every minibatch, and one flat
    all-reduce per Adam step sums the gradients and the metrics
    (``rl/ppo.PPO.update``); every rank then takes the same step.

A one-process run differs from the ranks' only in the order of those
sums, which Adam's normalised steps carry into the weights over many
steps. ``PPO(shares=world)`` on one process is the ranks' witness: it
takes the shares in turn and adds them in rank order, as two ranks'
all-reduce does.

Ranks start as ``torchrun`` starts them (``init_from_env`` reads
LOCAL_RANK / RANK / WORLD_SIZE and MASTER_ADDR / MASTER_PORT), or from
``init``. The backend is ``nccl`` for GPUs and ``gloo`` for the CPU, or
the one named. Gloo moves no CUDA tensor: under gloo a CUDA tensor is
copied to the host for each collective and back, which ``init`` prints.
``dryrun`` spawns the ranks of a short training run and checks them.
"""
from __future__ import annotations

import dataclasses
import os
import socket
import time
import traceback
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as tdist

# (metrics rtol, metrics atol, parameters atol or None) of the JAX
# package's sharded runs against its unsharded ones
# (tests/test_multichip.py): a vector-obs task, and a camera task, whose
# conv weight gradients sum large terms that cancel, so that Adam's
# normalised steps carry the summation order's noise into the weights
VECTOR_TOL = (2e-3, 2e-4, 5e-4)
VISION_TOL = (5e-3, 5e-4, None)
# the ranks against their one-process witness (PPO(shares=world)), which
# adds the shares' gradients in the order the all-reduce adds them
BITWISE = (0.0, 0.0, 0.0)


@dataclasses.dataclass(frozen=True)
class Group:
    """This process's place in the run: its rank among ``world`` ranks,
    its GPU on its host (``local_rank``) and the collectives' backend."""
    rank: int
    world: int
    local_rank: int
    backend: str


def init(rank: int, world: int, backend: Optional[str] = None,
         init_method: Optional[str] = None,
         local_rank: Optional[int] = None) -> Group:
    """Join the process group: ``backend`` defaults to nccl where CUDA is
    available and gloo elsewhere; ``init_method`` defaults to torchrun's
    environment (MASTER_ADDR / MASTER_PORT)."""
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    local_rank = rank if local_rank is None else local_rank
    if backend == "nccl":
        torch.cuda.set_device(local_rank)
    tdist.init_process_group(backend, init_method=init_method or "env://",
                             rank=rank, world_size=world)
    if backend == "gloo" and torch.cuda.is_available():
        print(f"[dist] rank {rank} of {world}: gloo; CUDA tensors are copied "
              f"through the host for every collective", flush=True)
    return Group(rank=rank, world=world, local_rank=local_rank,
                 backend=backend)


def init_from_env(backend: Optional[str] = None) -> Optional[Group]:
    """``init`` from torchrun's LOCAL_RANK / RANK / WORLD_SIZE; None where
    WORLD_SIZE is unset (a single-process run). A group that exists
    already is returned as it is."""
    if tdist.is_available() and tdist.is_initialized():
        return current()
    if "WORLD_SIZE" not in os.environ:
        return None
    rank = int(os.environ.get("RANK", "0"))
    return init(rank, int(os.environ["WORLD_SIZE"]), backend,
                local_rank=int(os.environ.get("LOCAL_RANK", rank)))


def current() -> Optional[Group]:
    """The group this process has joined, or None."""
    if not (tdist.is_available() and tdist.is_initialized()):
        return None
    rank = tdist.get_rank()
    return Group(rank=rank, world=tdist.get_world_size(),
                 local_rank=int(os.environ.get("LOCAL_RANK", rank)),
                 backend=tdist.get_backend())


def rank() -> int:
    g = current()
    return 0 if g is None else g.rank


def world_size() -> int:
    g = current()
    return 1 if g is None else g.world


def is_main_process() -> bool:
    """Rank 0, or a process outside any group: the one that logs and
    writes checkpoints."""
    return rank() == 0


def env_shard(num_envs: int, rank: int, world: int) -> Tuple[int, int]:
    """(first env, envs) of ``rank``'s contiguous block of ``num_envs``."""
    if num_envs % world:
        raise ValueError(f"{num_envs} envs do not split evenly over {world} "
                         f"ranks")
    n = num_envs // world
    return rank * n, n


def destroy() -> None:
    if tdist.is_available() and tdist.is_initialized():
        tdist.destroy_process_group()


# ---------------------------------------------------------------------------
# collectives


def _staged(t: torch.Tensor) -> bool:
    return t.is_cuda and tdist.get_backend() == "gloo"


def all_reduce(t: torch.Tensor) -> torch.Tensor:
    """The sum over the ranks of ``t`` (float), a new tensor on ``t``'s
    device."""
    x = t.detach().clone().contiguous()
    if _staged(x):
        host = x.cpu()
        tdist.all_reduce(host)
        return host.to(t.device)
    tdist.all_reduce(x)
    return x


def all_gather_cat(t: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Every rank's ``t`` concatenated along ``dim`` in rank order (the
    shapes agree on every rank)."""
    x = t.detach().contiguous()
    src = x.cpu() if _staged(x) else x
    parts = [torch.empty_like(src) for _ in range(tdist.get_world_size())]
    tdist.all_gather(parts, src)
    return torch.cat(parts, dim=dim).to(t.device)


def broadcast_int(x: int, src: int = 0) -> int:
    """Rank ``src``'s integer on every rank."""
    dev = "cuda" if tdist.get_backend() == "nccl" else "cpu"
    t = torch.tensor([x], dtype=torch.int64, device=dev)
    tdist.broadcast(t, src)
    return int(t.item())


# ---------------------------------------------------------------------------
# dryrun: spawn the ranks of a short run and check them


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _kernel_launches() -> Dict[str, int]:
    """{kernel/variant: launches} of every kernel in this process."""
    from airgym_tpu_torch.experiments import fused_cnn
    from airgym_tpu_torch.ops import epoch_prep, fused_hovering
    from airgym_tpu_torch.ops import fused_rollout, fused_update
    from airgym_tpu_torch.render import raycast
    return {f"{k.name}/{v}": n
            for k in (fused_rollout.KERNEL, fused_update.KERNEL,
                      epoch_prep.KERNEL, fused_hovering.KERNEL,
                      raycast.KERNEL, raycast.DEPTH_KERNEL, fused_cnn.KERNEL)
            for v, n in k.launches.items() if n}


def _rank_main(rank: int, world: int, port: int, backend: str, target,
               args: tuple, queue) -> None:
    """One spawned rank: join the group, run ``target(group, *args)``
    and put its result (or the traceback) on ``queue``."""
    try:
        group = init(rank, world, backend,
                     init_method=f"tcp://localhost:{port}")
        queue.put((rank, target(group, *args)))
    except BaseException:
        queue.put((rank, {"error": traceback.format_exc()}))
        raise
    finally:
        destroy()


def spawn(world_size: int, target, args: tuple = (),
          backend: Optional[str] = None, timeout: float = 900.0) -> list:
    """Run ``target(group, *args)`` (a module-level function) in
    ``world_size`` new processes joined over ``backend`` at a free
    localhost port; returns the results in rank order. Raises
    RuntimeError when a rank fails or does not report within
    ``timeout`` seconds; every process is joined or killed."""
    import multiprocessing
    import queue as queue_mod
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    ctx = multiprocessing.get_context("spawn")
    q = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world_size, port, backend, target, args, q))
             for r in range(world_size)]
    for p in procs:
        p.start()
    results, clean = {}, False
    failed = lambda: any(isinstance(r, dict) and "error" in r
                         for r in results.values())
    deadline = time.monotonic() + timeout
    try:
        while len(results) < world_size and not failed():
            try:
                rank, res = q.get(timeout=1.0)
                results[rank] = res
                continue
            except queue_mod.Empty:
                pass
            dead = [r for r, p in enumerate(procs)
                    if p.exitcode not in (None, 0) and r not in results]
            if dead or time.monotonic() > deadline:
                raise RuntimeError(
                    f"{len(results)} of {world_size} ranks reported; ranks "
                    f"{dead} exited without a report" if dead else
                    f"{len(results)} of {world_size} ranks reported within "
                    f"{timeout} s")
        clean = not failed()
    finally:
        # a rank that failed leaves the others waiting in a collective
        for p in procs:
            p.join(timeout=60 if clean else 5)
            if p.is_alive():
                p.kill()
                p.join()
    errors = [r["error"] for r in results.values()
              if isinstance(r, dict) and "error" in r]
    if errors:
        raise RuntimeError("a rank failed:\n" + "\n".join(errors))
    return [results[r] for r in range(world_size)]


def train_report(group: Group, yaml_cfg: Dict[str, Any],
                 args: Dict[str, Any]) -> dict:
    """Train ``yaml_cfg`` through the runner on this rank (on a GPU,
    ``cuda:rank % GPUs``) and report its parameters, logged metrics,
    the run's seed, the seed that torch's global RNG holds, what it
    wrote and its kernel launches."""
    args = dict(args)
    if str(args.get("device", "cuda")).startswith("cuda"):
        args["device"] = f"cuda:{group.rank % torch.cuda.device_count()}"
    from airgym_tpu_torch.rl.runner import Runner
    ts, info = Runner().load(yaml_cfg).run_train(args)
    params = torch.cat([p.detach().reshape(-1).cpu()
                        for p in ts.model.parameters()])
    return {"rank": group.rank, "world": group.world,
            "backend": group.backend, "params": params.numpy(),
            "history": info["history"], "seed": info["seed"],
            "torch_seed": torch.initial_seed(),
            "checkpoint": info["checkpoint"], "run_dir": info["run_dir"],
            "launches": _kernel_launches()}


def compare_history(got: List[dict], want: List[dict], rtol: float,
                    atol: float,
                    keys=("mean_reward", "loss", "kl", "lr", "a_loss",
                          "c_loss", "b_loss", "entropy", "clip_frac",
                          "mean_ep_length", "reward_raw_per_step",
                          "explained_variance")) -> List[str]:
    """The logged metrics of two runs that differ beyond rtol / atol: a
    list of 'epoch key got want'."""
    bad = []
    if len(got) != len(want):
        return [f"{len(got)} logged epochs against {len(want)}"]
    for a, b in zip(got, want):
        for k in keys:
            if k in b and not np.isclose(a[k], b[k], rtol=rtol, atol=atol):
                bad.append(f"epoch {b['epoch']} {k} {a[k]!r} {b[k]!r}")
    return bad


def check_reports(reports: List[dict], run_root: str,
                  reference: Optional[Tuple[np.ndarray, List[dict]]] = None,
                  tol: tuple = VECTOR_TOL) -> None:
    """``train_report``'s reports of one run's ranks: their parameters
    and logged metrics are bitwise equal, rank r's global torch RNG
    holds seed + r, exactly one rank (rank 0) wrote, and ``run_root``
    holds one run directory; given ``reference`` = (flat parameters,
    history) of a one-process run of the same config and seed, the
    metrics and the parameters are within ``tol`` (VECTOR_TOL or
    VISION_TOL of a plain run, BITWISE of the witness) of it.
    Raises RuntimeError otherwise."""
    strip = lambda h: [{k: v for k, v in row.items()
                        if k not in ("seconds", "fps")} for row in h]
    p0 = reports[0]["params"]
    for r in reports[1:]:
        if not np.array_equal(r["params"], p0):
            raise RuntimeError(f"rank {r['rank']}'s parameters differ from "
                               f"rank 0's")
        if strip(r["history"]) != strip(reports[0]["history"]):
            raise RuntimeError(f"rank {r['rank']}'s metrics differ from "
                               f"rank 0's")
    for r in reports:
        if r["torch_seed"] != r["seed"] + r["rank"]:
            raise RuntimeError(
                f"rank {r['rank']}: torch's global RNG holds seed "
                f"{r['torch_seed']}, want seed + rank = "
                f"{r['seed'] + r['rank']}")
    writers = [r["rank"] for r in reports if r["checkpoint"] is not None]
    runs = sorted(os.listdir(run_root)) if os.path.isdir(run_root) else []
    if writers != [0] or len(runs) != 1:
        raise RuntimeError(f"checkpoints from ranks {writers}, run "
                           f"directories {runs}: want rank 0 and one")
    if reference is not None:
        ref_params, ref_history = reference
        rtol, atol, param_atol = tol
        bad = compare_history(reports[0]["history"], ref_history, rtol, atol)
        err = float(np.max(np.abs(p0 - ref_params)))
        if bad or (param_atol is not None and err > param_atol):
            raise RuntimeError(f"against the one-process run: parameters "
                               f"{err:.3e} apart (limit {param_atol}); "
                               f"metrics beyond rtol {rtol} / atol {atol}: "
                               f"{bad}")


def dryrun(world_size: int, yaml_cfg: Dict[str, Any], args: Dict[str, Any],
           backend: Optional[str] = None,
           reference: Optional[Tuple[np.ndarray, List[dict]]] = None,
           tol: tuple = VECTOR_TOL, timeout: float = 900.0) -> List[dict]:
    """Spawn ``world_size`` ranks that each train ``yaml_cfg`` through the
    runner with ``args`` (``train_report``), then ``check_reports`` them
    against ``args['run_root']``, which should start empty, and
    ``reference`` within ``tol``. Returns the ranks' reports in rank
    order."""
    reports = spawn(world_size, train_report, (yaml_cfg, args), backend,
                    timeout)
    check_reports(reports, args.get("run_root") or "runs", reference, tol)
    return reports
