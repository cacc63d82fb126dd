"""Take the readings a cell's limits are set from, on the chip, in one
process: each compared number of the program on many seeds, of the cell's
control, and of each fault planted underneath, at the cell's own sizes.

    python3 -m portbench.readings --workload <cell> --seeds 11,12,13 \
        [--variant program|program_int4|control|fault:<name>[,...]] [--seconds 3]

One JSON line a variant and seed: {"seed", "variant", "correct",
"compared": {name: value}, "counters"}. A serving run's window is ``--seconds`` long at the
cell's own load; a training control has no window. The benchmark's runs
do not run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from portbench import harness


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--variant", default="program")
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    _, cell, cfg = harness.cell_files(args.workload)
    import torch

    if not torch.cuda.is_available():
        print("portbench.readings: no CUDA device", file=sys.stderr)
        return 2
    drv = harness.driver(cell["kind"])
    for name in args.variant.split(","):
        _read(drv, cell, cfg, name, [int(s) for s in args.seeds.split(",")], args.seconds)
    return 0


def _read(drv, cell, cfg, name, seeds, seconds) -> None:
    import torch

    variant, fault = name, None
    if variant.startswith("fault:"):
        variant, fault = "program", variant.split(":", 1)[1]
    for seed in seeds:
        ctx = harness.Context(cell=cell, cfg=cfg, seed=seed, seconds=seconds, trace=False,
                              device=torch.device("cuda", 0), t_start=time.perf_counter(),
                              variant=variant, fault=fault)
        t = time.perf_counter()
        if variant == "control" and hasattr(drv, "control"):
            rec = drv.control(ctx)
        else:
            rec = drv.run(ctx)
        print(json.dumps({"seed": seed, "variant": name, "correct": rec.correct,
                          "attempted": rec.attempted, "failed": rec.failed,
                          "compared": {k: v for k, (v, _) in rec.compared.items()},
                          "counters": rec.counters, "setup_s": rec.setup_s,
                          "seconds": time.perf_counter() - t}), flush=True)
        del rec
        harness.free(ctx.device)


if __name__ == "__main__":
    sys.exit(main())
