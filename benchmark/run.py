"""Run one cell of the benchmark on the CUDA card and print its result.

    python3 benchmark/run.py --workload albatite.fit --seed 7 --seconds 40 --trace 0

From the root of a checkout. The last line of standard output is one JSON
object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` ``breakdown``; then ``card`` and, last, ``checks``:
each judged number with its limit, which also close standard error).
Without a card, or with fewer cards than the cell asks for, it prints no
result and exits 2; if JAX or the JAX package is loaded by the end it
exits 3.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# every build and kernel cache inside the checkout, at fixed paths (the
# port's own nvcc and g++ builds go to <checkout>/build already)
for _var, _sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[_var] = os.path.join(ROOT, "build", "benchmark_cache", _sub)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True, help="a cell of BENCHMARK.json")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True, help="length of the window")
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from benchmark import harness

    try:
        line = harness.run_cell(args.workload, args.seed, args.seconds, args.trace, T0)
    except harness.NoCard as exc:
        print(f"benchmark: {exc}", file=sys.stderr)
        return 2
    bad = harness.forbidden_modules()
    if bad:
        print(f"benchmark: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
