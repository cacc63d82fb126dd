"""Run one cell of the benchmark once and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds ``posetpu_torch``. Set-up (weights,
the program's build and calibration, warm-up) runs first, then the window
of ``--seconds``, then with ``--trace 1`` a profiled sub-window, then the
comparison with the plain reference that decides ``correct``. The last
line of standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with ``--trace
1`` its per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and
last ``compared``: each number compared with its limit. The same numbers
end standard error.

Exits non-zero and prints no result where CUDA is missing or has fewer
devices than the cell asks for, or where a module of JAX or of the JAX
package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from portbench import harness  # noqa: E402


def _fixed_caches() -> None:
    """Kernel caches at fixed paths inside the checkout (the program's
    nvcc libraries already go to build/kernels there)."""
    build = harness.ROOT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _fixed_caches()

    bench, cell, cfg = harness.cell_files(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: needs {cell['chips']} CUDA device(s); torch.cuda.is_available() "
              f"{torch.cuda.is_available()}, {torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    ctx = harness.Context(cell=cell, cfg=cfg, seed=args.seed, seconds=args.seconds,
                          trace=bool(args.trace), device=torch.device("cuda", 0),
                          t_start=T_START)
    rec = harness.driver(cell["kind"]).run(ctx)

    banned = harness.loaded_banned()
    if banned:
        print(f"portbench: the run loaded {banned}", file=sys.stderr)
        return 1
    metrics = {}
    for m in harness.metrics_for(bench, cell["name"], ctx.trace):
        value = harness.reader(m["name"])(rec)
        if value is None and not ctx.trace:
            print(f"portbench: no reading of {m['name']}", file=sys.stderr)
            return 1
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
              "memory_peak_bytes": rec.memory_peak_bytes}
    result = {"correct": rec.correct, "attempted": rec.attempted, "failed": rec.failed,
              "metrics": metrics, "device": device}
    if ctx.trace:
        tr = rec.trace
        device["busy_s"] = tr.busy_us() / 1e6
        device["window_s"] = tr.wall_s
        result["breakdown"] = tr.breakdown()
        print(f"portbench: traced {tr.iterations} iterations, {len(tr.ops)} device operations, "
              f"{len(tr.host_ops)} runtime calls, read in {tr.reduce_s:.2f} s; "
              + json.dumps(tr.clock_check), file=sys.stderr)
    result["compared"] = {k: {"value": v, "limit": lim} for k, (v, lim) in rec.compared.items()}
    print(f"portbench: set-up {rec.setup_s:.3f} s " + json.dumps(rec.setup_parts), file=sys.stderr)
    print(f"portbench: window {rec.iterations} iterations, {rec.groups} groups in "
          f"{rec.window_s:.3f} s", file=sys.stderr)
    if rec.counters:
        print("portbench: counters " + json.dumps(rec.counters), file=sys.stderr)
    print(f"portbench: correct {rec.correct}", file=sys.stderr)
    for k, (v, lim) in rec.compared.items():
        print(f"compared {k} {v!r} limit {lim!r}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
