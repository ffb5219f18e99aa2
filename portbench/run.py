"""The benchmark of airgym_tpu_torch on the card: one cell, one run.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Set-up builds the cell's system from its configuration and traffic files
and drives it from the seed through the steps the comparison checks; the
window then runs the cell's traffic for ``--seconds``; the reference
works the checked steps out again; the last line of standard output is
the result (``--trace 0``: the end-to-end metrics; ``--trace 1``: the
per-layer metrics, read from a profiled stretch after the window). Each
number compared and its limit also go to standard error, last.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# build caches inside the checkout, at fixed paths: the program's nvcc
# builds go to build/torch_kernels (kernels/build.py); torch's own
# runtime-compiled kernels to build/torch_kernel_cache
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"),
                 ("PYTORCH_KERNEL_CACHE_PATH", "torch_kernel_cache")):
    os.environ[var] = str(ROOT / "build" / sub)
    os.makedirs(os.environ[var], exist_ok=True)
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    # one host thread for the CPU side of the run: the load of one
    # process with few threads keeps the host-bound cells steady
    torch.set_num_threads(1)
    from portbench import harness
    w = harness.cell(args.workload)
    driver = harness.driver(w["traffic_file"]["kind"])
    harness.require_cards(w["chips"])
    res = driver.run(w, args.seed, args.seconds, bool(args.trace), T_START)

    found = harness.banned_modules()
    if found:
        print(f"modules of JAX or the JAX package were loaded: {found}",
              file=sys.stderr)
        return 3
    correct, checks = harness.judge(res["numbers"], w["limits"])
    for name, value in res.get("look", {}).items():
        print(f"look {name}: {value!r}", file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    line = {"correct": correct, "attempted": res["attempted"],
            "failed": res["failed"], "metrics": res["metrics"],
            "device": res["device"]}
    if "breakdown" in res:
        line["breakdown"] = res["breakdown"]
    # each number compared beside its limit, under a key of its own that
    # comes last on the line
    line["checks"] = checks
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
