"""The benchmark's command:

    python3 -m dcabench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  It runs the cell of ``BENCHMARK.json`` named
``<cell>`` on the cards of this machine (one rank process a card for a
cell on several), prints progress and the compared numbers on standard
error, and prints the result as one JSON object on the last line of
standard output.  Without enough cards it exits 2 and prints no result.
"""

from __future__ import annotations

import argparse
import os
import sys

# One host thread for every thread pool, set before numpy and torch load:
# the L-BFGS loop's small host solves otherwise wake pools whose timing
# follows the machine's other load.  Rank processes inherit it.
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"

from .harness import process_start  # noqa: E402

T_START = process_start()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m dcabench.run",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True, help="a cell of BENCHMARK.json")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True, help="length of the measured window")
    p.add_argument("--trace", type=int, choices=(0, 1), default=0,
                   help="1: report the per-layer metrics from a traced job")
    args = p.parse_args(argv)
    from .harness import run_cell

    return run_cell(args.workload, args.seed, args.seconds, bool(args.trace), t_start=T_START)


if __name__ == "__main__":
    sys.exit(main())
