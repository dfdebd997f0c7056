"""The readings that a cell's limits are set from:

    python3 benchmark/calibrate.py --workload <cell> --seeds 1 2 3 ...
        [--control-seeds 3] [--device cuda|cpu]

For each seed: the program's readings (the cell's comparison, without a
measured window, as its traffic kind's `calibrate_seed` makes it), and for
the first `--control-seeds` seeds the control's (the reference in float32
with TF32 matrix products, in the program's place) and each fault's,
planted in the reference put in the program's place. One JSON line per
seed and source on standard output.
"""

import argparse
import json
import os
import sys
import time

sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

import torch  # noqa: E402

from benchmark import harness  # noqa: E402
from benchmark.reference.common import Arith  # noqa: E402

CONTROL = Arith(torch.float32, tf32=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    device = torch.device("cuda:0" if args.device == "cuda" else "cpu")
    if device.type == "cuda" and not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    for i, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        cell = harness.Cell(args.workload, seed, 0.0, False, device, t0)
        rows = cell.traffic.calibrate_seed(cell, CONTROL, i < args.control_seeds)
        for source, readings in rows:
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "source": source, "readings": readings,
                              "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
