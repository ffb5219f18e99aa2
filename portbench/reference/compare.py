"""The numbers that decide ``correct``: the program's outputs against the
plain reference's. Each is a gap as a share of the reference's own size;
``limits/<cell>.json`` holds the limit of each and the readings it was
set from."""
from __future__ import annotations

import statistics
from typing import Any, Dict

import torch

# a leaf whose reference gradient is under this share of the median
# leaf's is nought to rounding (a bias under softmax, say) and moves under
# Adam by round-off alone: it is left out of the change
NOUGHT = 1e-3
# envs compared at a time: a rollout's fields in float64 take 8 bytes an
# element (16,384 envs' frames would take 23 GB at once)
ENVS = 512


def _norms(tree: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in
            tree.items()}


def worst_leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
                   keep) -> float:
    """max over the kept leaves of |prog norm - ref norm| / max(ref norm,
    the median kept leaf's ref norm)."""
    return max(leaf_gaps(prog, ref, keep).values())


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              keep) -> Dict[str, float]:
    """Each kept leaf's gap of ``worst_leaf_gap``."""
    med = statistics.median(ref[k] for k in keep)
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med) for k in keep}


def rollout_gaps(prog: Dict[str, Any], ref: Dict[str, Any],
                 by_field: bool = False):
    """Each env's gap between two first-epoch rollouts: over every field
    (time-major [T, N, ...], the observation dict's too), the env's
    largest |gap| as a share of the median env's largest |ref| value of
    that field (1 where that median is 0); ``by_field``: {field: the
    envs' gaps in it}."""
    gaps = {}

    def add(name, p, r):
        ref_max, gap_max = [], []
        for i in range(0, r.shape[1], ENVS):
            rr = r[:, i:i + ENVS].detach().double()
            pp = p[:, i:i + ENVS].detach().to(r.device).double()
            rr = rr.transpose(0, 1).reshape(rr.shape[1], -1)
            pp = pp.transpose(0, 1).reshape(pp.shape[1], -1)
            ref_max.append(rr.abs().amax(1))
            gap_max.append((pp - rr).abs().amax(1))
        scale = float(torch.median(torch.cat(ref_max))) or 1.0
        gaps[name] = torch.cat(gap_max) / scale

    for k, r in ref.items():
        if k == "frame_idx" or r is None:
            continue
        if isinstance(r, dict):
            for kk, rr in r.items():
                add(f"{k}.{kk}", prog[k][kk], rr)
        else:
            add(k, prog[k], r)
    return gaps if by_field else torch.stack(list(gaps.values())).amax(0)


def train_numbers(prog, ref, replay) -> Dict[str, float]:
    """``prog``, ``ref`` and ``replay`` are ``reference/train.Snapshot``s:
    the program's checked epochs, the reference's own from the seed, and
    the reference's first epoch on the program's rollout.
    rollout_gap.p99: the 99th percentile env's gap between the program's
    first rollout and the reference's (``rollout_gaps``); loss_gap,
    |loss gap| / |ref loss| of the first epoch; grad_gap, Adam's first
    moment after it (the gradients as the optimizer got them), worst
    leaf; change_gap, the parameters' change over it, worst leaf; these
    three against the replay."""
    env = rollout_gaps(prog.rollout, ref.rollout)
    g_ref, g_prog = _norms(replay.m1), _norms(prog.m1)
    keep = _moving(g_ref)
    return {"rollout_gap.p99": float(torch.quantile(env, 0.99)),
            "loss_gap": abs(prog.losses[0] - replay.losses[0])
            / abs(replay.losses[0]),
            "grad_gap": worst_leaf_gap(g_prog, g_ref, keep),
            "change_gap": _change_gap(prog.p0, prog.p1, replay.p0,
                                      replay.p1, keep)}


def ranks_numbers(prog_rollout, ref_rollout, prog_steps, ref_steps,
                  n: int = None) -> Dict[str, float]:
    """The numbers of a run over ranks. rollout_gap.p99: the ranks'
    gathered first rollout against the reference's own from the seed
    (``rollout_gaps``). Against the reference's first update replayed on
    that rollout, over its first ``n`` Adam steps (by default the last
    mark of the ``train.FirstSteps`` readings, one per rank):
    loss_gap.steps1-n, each rank's loss of each step against the
    reference's of that rank's share, as a share of it; grad_gap.step1,
    the first step's gradient as Adam gets it, worst leaf;
    change_gap.steps1-n, the parameters' change over the n steps, worst
    leaf; each the worst rank's. A rank whose update never ran reads 1."""
    env = rollout_gaps(prog_rollout, ref_rollout)
    n = n or max(ref_steps[0]["change"])
    gaps = steps_gaps(prog_steps, ref_steps, n)
    return {"rollout_gap.p99": float(torch.quantile(env, 0.99)),
            f"loss_gap.steps1-{n}": max(g["loss"] for g in gaps),
            "grad_gap.step1": max(g["grad"] for g in gaps),
            f"change_gap.steps1-{n}": max(g["change"] for g in gaps)}


def steps_gaps(prog_steps, ref_steps, n: int) -> list:
    """Each rank's gaps over the first ``n`` steps (a mark of the
    readings): the loss of each step, the first step's gradient and the
    change over the ``n`` steps, with the worst leaf of each norm."""
    keep = _moving(ref_steps[0]["grad"])
    out = []
    for p, r in zip(prog_steps, ref_steps):
        zero = {k: 0.0 for k in r["grad"]}
        losses = (p["losses"] + [0.0] * n)[:n]
        grad = leaf_gaps(p["grad"] or zero, r["grad"], keep)
        change = leaf_gaps(p["change"].get(n) or zero, r["change"][n], keep)
        out.append({"loss": max(abs(a - b) / abs(b) for a, b in
                                zip(losses, r["losses"][:n])),
                    "grad": max(grad.values()),
                    "change": max(change.values()),
                    "grad_leaf": max(grad, key=grad.get),
                    "change_leaf": max(change, key=change.get)})
    return out


def ranks_look(prog_rollout, ref_rollout, prog_steps,
               ref_steps) -> Dict[str, Any]:
    """The first rollout: the worst env, the share of envs over 1e-3 and
    the 99th percentile in each rank's block of envs, and the field of
    the worst env's gap; each rank's gaps over the steps to each mark
    (``steps_gaps``), with the worst leaf's name."""
    world = len(prog_steps)
    fields = rollout_gaps(prog_rollout, ref_rollout, by_field=True)
    env = torch.stack(list(fields.values())).amax(0)
    worst = int(env.argmax())
    out = {"rollout_gap.max": float(env.max()),
           "rollout_gap.worst_field": max(
               fields, key=lambda k: float(fields[k][worst])),
           "rollout_gap.share_over_1e-3": float(
               (env > 1e-3).double().mean())}
    for r, block in enumerate(env.chunk(world)):
        out[f"rollout_gap.share_over_1e-3.rank{r}"] = float(
            (block > 1e-3).double().mean())
        out[f"rollout_gap.p99.rank{r}"] = float(torch.quantile(block, 0.99))
    for n in sorted(ref_steps[0]["change"]):
        for r, g in enumerate(steps_gaps(prog_steps, ref_steps, n)):
            out.update({f"{k}_gap.steps1-{n}.rank{r}": g[k]
                        for k in ("loss", "change")})
            out[f"change_worst_leaf.steps1-{n}.rank{r}"] = g["change_leaf"]
            if n == min(ref_steps[0]["change"]):
                out[f"grad_gap.step1.rank{r}"] = g["grad"]
                out[f"grad_worst_leaf.rank{r}"] = g["grad_leaf"]
    return out


def train_look(prog, ref, replay) -> Dict[str, float]:
    """The learning rate, KL and clip fraction of the first epoch, the
    program's and the replay's (the update's discrete decisions); and
    against the reference's own run: the first rollout's worst env and
    the share of envs over 1e-3, each checked epoch's loss gap, and the
    change's gap over the first epoch and, where more epochs were
    checked (``control.py --epochs``), over all of them."""
    env = rollout_gaps(prog.rollout, ref.rollout)
    out = {"lr.epoch1": prog.lr1, "lr.epoch1.replay": replay.lr1}
    for k in ("kl", "clip_frac"):
        out[f"{k}.epoch1"] = prog.metrics1[k]
        out[f"{k}.epoch1.replay"] = replay.metrics1[k]
    out.update({
        "rollout_gap.max": float(env.max()),
        "rollout_gap.share_over_1e-3": float((env > 1e-3).double().mean())})
    out.update({f"loss_gap.epoch{e + 1}": abs(p - r) / abs(r)
                for e, (p, r) in enumerate(zip(prog.losses, ref.losses))})
    keep = _moving(_norms(ref.m1))
    out["change_gap.epoch1"] = _change_gap(prog.p0, prog.p1, ref.p0,
                                           ref.p1, keep)
    if len(ref.losses) > 1:
        out[f"change_gap.epochs1-{len(ref.losses)}"] = _change_gap(
            prog.p0, prog.p_end, ref.p0, ref.p_end, keep)
    return out


def _moving(g_ref):
    """The leaves whose reference gradient is not nought to rounding (and
    not exactly 0, where more than half the leaves get none)."""
    med = statistics.median(g_ref.values())
    return [k for k in g_ref if g_ref[k] >= NOUGHT * med and g_ref[k] > 0]


def _change_gap(p_a, p_b, r_a, r_b, keep) -> float:
    dev = r_a[keep[0]].device
    d_ref = _norms({k: r_b[k] - r_a[k] for k in keep})
    d_prog = _norms({k: p_b[k].to(dev) - p_a[k].to(dev) for k in keep})
    return worst_leaf_gap(d_prog, d_ref, keep)


def sim_numbers(prog_rows, prog_rew, ref_rows, ref_rew) -> Dict[str, float]:
    """reward_gap.p99 / state_gap.p99: the 99th percentile sampled env's
    reward-sum gap and state gap (``_per_env``), which a small error in
    more than one answer in a hundred fails. The worst env's gaps are only
    looked at (``sim_look``): a rounding difference flips an exit in a
    handful of sound envs, and one such env can read near 1 (PERF.md)."""
    rew, st = _per_env(prog_rows, prog_rew, ref_rows, ref_rew)
    q = lambda x: float(torch.quantile(x, 0.99))
    return {"reward_gap.p99": q(rew), "state_gap.p99": q(st)}


def _per_env(prog_rows, prog_rew, ref_rows, ref_rew):
    """Each sampled env's reward-sum gap and state gap (over its 29 rows),
    as shares of the larger of its own ref size and the median env's."""
    rr = ref_rew.abs()
    rew = (prog_rew - ref_rew).abs() / torch.clamp_min(
        rr, float(torch.median(rr)))
    d = torch.linalg.vector_norm((prog_rows - ref_rows).double(), dim=0)
    r = torch.linalg.vector_norm(ref_rows.double(), dim=0)
    return rew.double(), d / torch.clamp_min(r, float(torch.median(r)))


def sim_look(prog_rows, prog_rew, ref_rows, ref_rew) -> Dict[str, float]:
    """The spread of the per-env gaps over the sample: quantiles and the
    share of envs past 1e-6, 1e-4 and 1e-2."""
    rew, st = _per_env(prog_rows, prog_rew, ref_rows, ref_rew)
    out = {}
    for name, x in (("reward", rew), ("state", st)):
        q = torch.quantile(x, torch.tensor([0.5, 0.9, 0.99],
                                           dtype=x.dtype, device=x.device))
        out.update({f"{name}.p50": float(q[0]), f"{name}.p90": float(q[1]),
                    f"{name}.p99": float(q[2]), f"{name}.max": float(x.max())})
        for t in (1e-6, 1e-4, 1e-2):
            out[f"{name}.share_over_{t:g}"] = float((x > t).double().mean())
    return out
