"""The readings a cell's correctness limits are set from, on the card.

    python3 port_bench/control.py --workload <cell> --seeds 12 --control-seeds 3 --seconds 3

For each seed, one run of the cell with a short window, in this one process:
the program's readings against the reference (``check.py``), and for the first
``--control-seeds`` seeds the control's, the reference one precision lower than
the configuration states put in the program's place. One JSON line per seed,
then the summary: per number the program's largest reading (the lower), the
control's smallest (the upper), and a limit between them,
``lower ** (1/3) * upper ** (2/3)``, where the upper is three times the lower
or more. The benchmark's own runs do not run this.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

from port_bench import harness  # noqa: E402


def summary(program, control):
    out = {}
    for name in program[0]:
        lower = max(r[name] for r in program)
        uppers = [c[name] for c in control if name in c]
        upper = min(uppers) if uppers else None
        row = {"lower": lower, "upper": upper}
        if upper is not None and lower > 0 and upper >= 3 * lower:
            row["limit"] = lower ** (1 / 3) * upper ** (2 / 3)
        out[name] = row
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, default=12)
    parser.add_argument("--control-seeds", type=int, default=3)
    parser.add_argument("--seconds", type=float, default=3.0)
    parser.add_argument("--first-seed", type=int, default=3_000_000_000)
    parser.add_argument("--compute-dtype", default=None,
                        help="run the program in this dtype instead (a witness, not a cell)")
    parser.add_argument("--fault", choices=("half-batch",), default=None,
                        help="plant a fault in the program: each step's mean over half of its rows")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    torch.set_num_threads(1)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        cell = harness.Cell(json.load(f), args.workload, limits={})
    if args.compute_dtype:
        cell.hp["compute_dtype"] = args.compute_dtype
    if args.fault == "half-batch":
        from self_attention_tacotron_torch.training.trainer import Trainer

        real = Trainer._batch

        def half(self, batch):
            out = real(self, batch)
            rows = out["source"].shape[0] // 2
            return {k: v[:rows] for k, v in out.items()}

        Trainer._batch = half
    program, control = [], []
    for k in range(args.seeds):
        seed = args.first_seed + 7919 * k
        result = harness.run_cell(cell, seed, args.seconds, False,
                                  control=k < args.control_seeds, readings=True)
        program.append(result["readings"])
        if result.get("control"):
            control.append(result["control"])
        print(json.dumps({"seed": seed, "program": result["readings"],
                          "control": result.get("control"),
                          "left_out": result.get("left_out"),
                          "attempted": result["attempted"]}), flush=True)
    print(json.dumps({"workload": args.workload, "summary": summary(program, control)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
