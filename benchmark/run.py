"""Run one cell of the benchmark of `gpode_tpu_torch` once:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the CUDA card(s) the cell
asks for. The last line of standard output is the result: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics, or with
`--trace 1` its per-layer ones), `device`, with `--trace 1` a `breakdown`,
and last `checks`, each compared number with its limit. The numbers also
close standard error. See `benchmark/harness.py` for the files a cell is
made of.
"""

import os
import sys
import time

T_START = time.perf_counter()

# the checkout root, in place of this directory: the harness is the package
# `benchmark`, and its modules do not shadow the standard library's
sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from benchmark import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(t_start=T_START))
