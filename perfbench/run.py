"""Run one cell of the benchmark once:

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The last line of standard output is the
result's JSON; the numbers that decide ``correct`` and their limits are the
last lines of standard error. Exits non-zero and prints no result without
the CUDA cards the cell asks for.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def cache_dirs(root: Path) -> None:
    """Keep the kernel caches inside the checkout, at fixed paths, before
    anything imports Triton (the CUDA libraries build under
    ``build/kernels`` beside them)."""
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(root / "build" / "nv")


def main(argv=None, root=None, device=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cache_dirs(ROOT)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from perfbench import harness

    return harness.run(Path(root or ROOT), args.workload, args.seed, args.seconds,
                       bool(args.trace), T0, device=device)


if __name__ == "__main__":
    sys.exit(main())
