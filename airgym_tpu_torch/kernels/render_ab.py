"""Two builds of the depth camera's kernels on one card: this tree's
``csrc/render_process.cu`` and ``csrc/render_depth.cu`` and another
version of them, such as an earlier commit's written out with
``git show``:

    mkdir -p build/other
    for f in render_process.cu render_depth.cu raycast.cuh common.cuh; do
        git show HEAD~1:airgym_tpu_torch/csrc/$f > build/other/$f; done
    python -m airgym_tpu_torch.kernels.render_ab --other build/other --clocks

On the render cases of ``chip_smoke.py`` (render + process: Planning at
4096 envs culled, a one-box scene at 1024 envs like Avoid's, a mixed
scene of all four record kinds at 256 envs; raw depth: MAPlanning's
16,384 cameras, DepthGen's 1024 envs x 168 records, the mixed scene
culled) it prints, for each case, the number of output elements whose
bits differ between the two builds and the time of each, taken in turns
(other / this / this / other, each the median of 20 CUDA-event timings).

With ``--clocks`` both sources are built once more with
``-DAIRGYM_RENDER_CLOCKS``: thread 0 of every block adds the cycles of
each phase to device counters (``render_process_phase_cycles``,
``render_depth_phase_cycles``), printed per env and as shares for each
case; and ``cuobjdump -sass`` of that build counts the SASS instructions
of its ``sass_probe<KIND>`` kernels, one record's cast body per kind
less the empty probe. A build whose source lacks them says so. Needs a
GPU; prints the card's name and power limit first.

The case builders (``process_cases``, ``depth_cases``) are also
``chip_smoke.py``'s.
"""
from __future__ import annotations

import argparse
import ctypes
import re
import statistics
import subprocess
from pathlib import Path

import torch

from airgym_tpu_torch.kernels import build
from airgym_tpu_torch.render import raycast as rc

REPS = 20
# phases of a block that the clock builds time, in order
PHASES = {"render_process": ("prepass", "cast", "noise 1 + max",
                             "noise 2 + max", "blur"),
          "render_depth": ("prepass", "cast")}
LAUNCH = {"render_process": rc.launch_process, "render_depth": rc.launch_depth}
KINDS = ("cylinder", "sphere", "box", "annulus")


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


def mixed_scene(u, n, dev):
    """A scene of all four record kinds in front of a camera at (0, 0, 1):
    20 cylinders (some invalid), 3 spheres, 3 boxes, 3 annuli, the ground;
    ``u(*shape)`` draws uniforms."""
    from airgym_tpu_torch.physics import scene as sc
    from airgym_tpu_torch.render import depth as dr
    unit = lambda x: x / x.norm(dim=-1, keepdim=True)
    ones = lambda k: torch.ones((n, k), dtype=torch.bool, device=dev)
    cyl = sc.Cylinders(
        center=torch.stack([9 * u(n, 20) - 3, 4 * u(n, 20) - 2,
                            torch.full((n, 20), 1.2, device=dev)], -1),
        axis=unit(torch.cat([0.6 * u(n, 20, 2) - 0.3,
                             torch.ones((n, 20, 1), device=dev)], -1)),
        half_len=0.8 + 0.8 * u(n, 20), radius=0.05 + 0.35 * u(n, 20),
        valid=u(n, 20) > 0.1)
    sph = sc.Spheres(center=torch.stack([0.5 + 3.5 * u(n, 3), 2 * u(n, 3) - 1,
                                         0.6 + 0.8 * u(n, 3)], -1),
                     radius=0.1 + 0.3 * u(n, 3), valid=ones(3))
    boxes = sc.Boxes(center=torch.stack([1 + 3 * u(n, 3), 3 * u(n, 3) - 1.5,
                                         0.3 + 1.2 * u(n, 3)], -1),
                     yaw=6 * u(n, 3) - 3, half_extents=0.1 + 0.4 * u(n, 3, 3),
                     valid=ones(3))
    ann = sc.Annuli(center=torch.stack([1.5 + 2 * u(n, 3), 1.6 * u(n, 3) - 0.8,
                                        0.8 + 0.4 * u(n, 3)], -1),
                    normal=unit(torch.cat([torch.ones((n, 3, 1), device=dev),
                                           0.8 * u(n, 3, 2) - 0.4], -1)),
                    r_in=0.2 + 0.2 * u(n, 3), r_out=0.5 + 0.3 * u(n, 3),
                    half_thick=0.02 + 0.08 * u(n, 3), valid=ones(3))
    return dr.SceneForRender(cylinders=cyl, spheres=sph, boxes=boxes,
                             annuli=ann, ground=True)


def process_cases(dev):
    """The render + process kernel's inputs: Planning at 4096 envs after
    30 env steps, culled at 4.5 m; a one-box scene at 1024 envs (too small
    to cull: the unguarded chain); the mixed scene at 256 envs, culled."""
    from airgym_tpu_torch import envs
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
    cases = {"planning 4096 guarded": rc.prepare(
        task.cam_cfg, root, task.scene(st), 987654321,
        task.cam_cfg.depth_clamp)}

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
    cases["box 1024 unguarded"] = rc.prepare(
        task.cam_cfg, box_root, dr.SceneForRender(boxes=box, ground=True), 5,
        4.5)

    n = 256
    mix_root = root[:n].clone()
    mix_root[:, 0:3] = torch.tensor([0.0, 0.0, 1.0], device=dev)
    cases["mixed 256 guarded"] = rc.prepare(
        task.cam_cfg, mix_root, mixed_scene(u, n, dev), 77, 4.5)
    return cases


def depth_cases(dev):
    """The raw depth kernel's inputs: MAPlanning's 4096 envs x 4 robots
    after 30 env steps; DepthGen's 1024-env scene of 168 records
    (unguarded); the mixed scene at 256 envs, culled at 4.5 m."""
    from airgym_tpu_torch import envs
    ma = envs.make_task("maplanning", num_envs=4096, device=dev)
    g = torch.Generator(device=dev).manual_seed(31)
    st = ma.initial_state(g)
    for _ in range(30):
        a = torch.rand((ma.flat_n, 4), generator=g, device=dev) * 1.2 - 0.6
        a[:, 3] = -0.69 + 0.1 * a[:, 3]
        st, _ = ma.step(st, a, g, render=False)
    root = st.core.root
    cases = {"maplanning 16384": rc.prepare(ma.cam_cfg, root,
                                            ma.scene(root, st.goal))}

    dg = envs.make_task("depthgen", num_envs=1024, device=dev)
    dst = dg.initial_state(torch.Generator(device=dev).manual_seed(32))
    cases["depthgen 1024 unguarded"] = rc.prepare(dg.cam_cfg, dst.core.root,
                                                  dg.scene(dst))

    rng = torch.Generator(device=dev).manual_seed(33)
    u = lambda *shape: torch.rand(shape, generator=rng, device=dev)
    n = 256
    mix_root = root[:n].clone()
    mix_root[:, 0:3] = torch.tensor([0.0, 0.0, 1.0], device=dev)
    cases["mixed 256 guarded"] = rc.prepare(ma.cam_cfg, mix_root,
                                            mixed_scene(u, n, dev), None, 4.5)
    return cases


def kernels(src_dir=None, clocks=False):
    """{kernel name: CudaKernel} of the two render sources in ``src_dir``
    (this tree's by default), with their phase clocks if ``clocks``."""
    out = {}
    for base in (rc.KERNEL, rc.DEPTH_KERNEL):
        k = build.CudaKernel(base.name, dict(base.entry_points),
                             base.extra_flags
                             + (["-DAIRGYM_RENDER_CLOCKS"] if clocks else []))
        if src_dir is not None:
            k.source = Path(src_dir).resolve() / f"{base.name}.cu"
        out[base.name] = k
    return out


def phase_cycles(kernel, fn):
    """Run ``fn`` once on ``kernel``'s clock build -> cycles per phase
    summed over blocks, or None if the source has no clocks."""
    entry = f"{kernel.name}_phase_cycles"
    lib = kernel.lib()
    if not hasattr(lib, entry):
        return None
    getattr(lib, entry).argtypes = [ctypes.c_void_p]
    getattr(lib, entry).restype = ctypes.c_int
    cyc = (ctypes.c_ulonglong * len(PHASES[kernel.name]))()
    kernel.call(entry, cyc)                  # reads and zeroes them
    fn()
    torch.cuda.synchronize()
    kernel.call(entry, cyc)
    return list(cyc)


def split_line(kernel, cyc, n_env):
    total = max(sum(cyc), 1)
    return "; ".join(f"{name} {c / n_env:.0f} ({100 * c / total:.1f}%)"
                     for name, c in zip(PHASES[kernel.name], cyc))


def sass_counts(kernel):
    """SASS instructions (NOPs left out) of each kernel in ``kernel``'s
    library: {function name: count}; empty without cuobjdump."""
    return {fn: len(instrs) for fn, instrs in build.sass(kernel).items()}


def cast_body_counts(counts):
    """Per record kind: instructions of ``sass_probe<KIND>`` less those of
    ``sass_probe<0>`` (the same probe without a cast), or None."""
    probe = {}
    for fn, c in counts.items():
        m = re.search(r"sass_probeILi(\d)E", fn)
        if m:
            probe[int(m.group(1))] = c
    if 0 not in probe:
        return None
    return {KINDS[k - 1]: probe[k] - probe[0] for k in range(1, 5)
            if k in probe}


def print_build(tag, k):
    for line in k.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build {tag}] {k.name}: {line.strip()}", flush=True)


def print_sass(tag, k):
    counts = sass_counts(k)
    if not counts:
        print(f"[sass {tag}] {k.name}: no cuobjdump", flush=True)
        return
    body = cast_body_counts(counts)
    main = {fn: c for fn, c in counts.items() if "sass_probe" not in fn}
    print(f"[sass {tag}] {k.name}: kernels {main}; one record's cast body "
          f"per kind {body if body else 'not in this source'}", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True, type=Path,
                    help="directory holding the other render_process.cu, "
                         "render_depth.cu and their headers")
    ap.add_argument("--clocks", action="store_true",
                    help="also build both with -DAIRGYM_RENDER_CLOCKS and "
                         "print each case's phase split and the SASS counts")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("render_ab needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    dev = torch.device("cuda")
    builds = {"this": kernels(), "other": kernels(args.other)}
    clk = ({"this": kernels(None, True), "other": kernels(args.other, True)}
           if args.clocks else {})
    secs = build.build_all([k for b in (*builds.values(), *clk.values())
                            for k in b.values()])
    print(f"[build] {sum(len(b) for b in (*builds.values(), *clk.values()))} "
          f"libraries in {secs:.1f} s", flush=True)
    for tag, b in builds.items():
        for k in b.values():
            print_build(tag, k)
    for tag, b in clk.items():
        for k in b.values():
            print_sass(tag, k)
    stream = torch.cuda.current_stream().cuda_stream
    groups = [("render_process", process_cases(dev)),
              ("render_depth", depth_cases(dev))]
    for name, cases in groups:
        launch = LAUNCH[name]
        for case, inp in cases.items():
            n = inp.origins.shape[0]
            fns = {tag: (lambda k=b[name]: launch(k, inp, stream))
                   for tag, b in builds.items()}
            outs = {tag: fn() for tag, fn in fns.items()}
            torch.cuda.synchronize()
            a, b = outs["this"], outs["other"]
            ne = int((a.view(torch.int32) != b.view(torch.int32)).sum())
            print(f"[{name} {case}] this vs other: {ne} of {a.numel()} "
                  f"elements differ, max|diff| "
                  f"{float((a - b).abs().max()):.3e}", flush=True)
            ms = {tag: [] for tag in fns}
            for tag in ["other", "this", "this", "other"]:
                ms[tag].append(time_ms(fns[tag]))
            print(f"[{name} {case}] ms: " + "; ".join(
                f"{tag} " + " ".join(f"{x:.3f}" for x in v)
                for tag, v in ms.items()), flush=True)
            for tag, b in clk.items():
                k = b[name]
                cyc = phase_cycles(k, lambda: launch(k, inp, stream))
                print(f"[{name} {case}] {tag} cycles per env: "
                      + (split_line(k, cyc, n) if cyc else "no clocks"),
                      flush=True)
            del outs, a, b
        del cases
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
