"""Run one cell of ``BENCHMARK.json`` once and print the result as one JSON line.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Exits with 1 and prints no result where there is no CUDA device or fewer than
the cell asks for, where the outputs' check cannot run, or where JAX, flax,
orbax or the JAX package was loaded. The numbers compared by the check are the
last lines on standard error, and the result's last key, ``checks``.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    from port_bench import harness

    cell = harness.Cell(bench, args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark measures the card only", file=sys.stderr)
        return 1
    if torch.cuda.device_count() < int(cell.spec["chips"]):
        print(f"{cell.name} needs {cell.spec['chips']} devices, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 1
    # one process, one host thread for PyTorch's own CPU work: the loop is the
    # program's launches, and spare threads only contend with it
    torch.set_num_threads(1)
    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                              device="cuda", started=STARTED)
    banned = harness.banned_modules()
    if banned:
        print(f"loaded modules the benchmark must not load: {banned}", file=sys.stderr)
        return 1
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
