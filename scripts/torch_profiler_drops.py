"""How many kernel records torch.profiler keeps on the card, session by session.

    python scripts/torch_profiler_drops.py

Runs profiler sessions of a known number of kernel launches (elementwise
adds on a 1024 x 1024 float32 tensor, each session followed by a session of
5 matmuls) and prints, for each, the kernels launched against the kernel
records that ``key_averages()`` returns.  On a machine whose CUPTI delivers
every record the two are equal; where they differ, a profiler session's
device times undercount, and a short session can come back empty, so
``chip_smoke.py`` times with CUDA events and reads only kernel names and
shares from the profiler.  Needs a card; prints the card's name and power
limit first.
"""

import subprocess
import sys

import torch


def session(x, w, n: int, kind: str):
    """(kernels launched, kernel records returned) of one session."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            _ = x + 1.0 if kind == "add" else x @ w
        torch.cuda.synchronize()
    return n, sum(e.count for e in prof.key_averages() if e.device_time_total > 0)


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_profiler_drops: no card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    x = torch.randn(1024, 1024, device="cuda")
    w = torch.randn(1024, 1024, device="cuda")
    for n in (10, 100, 1000, 13000, 20, 5, 50000, 5, 5, 100000, 5, 5):
        adds = session(x, w, n, "add")
        mms = session(x, w, 5, "mm")
        print(f"adds launched {adds[0]}, recorded {adds[1]}; then matmuls launched {mms[0]}, "
              f"recorded {mms[1]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
