"""The readings that ``correct``'s limits are set from, for one cell.

    python3 sortbench/control.py --workload paper-p32.sort \
        --seeds 11,12,13 --control-seeds 21,22,23 --seconds 3

Prints one JSON line a seed (``side``: ``program`` or ``control``, the
numbers the judge compares, and which of them pass their limits), then
a summary: per number, the program's largest reading (the lower) and
the control's smallest (the upper), and whether every control seed
failed some number.  Runs on the card at the cell's own size; the
benchmark's own runs never run it."""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="", help="the program's seeds")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0,
                    help="each program seed's window")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    from sortbench.harness.calibrate import (control_readings, fails,
                                             program_readings)
    from sortbench.harness.manifest import load_cell

    if not torch.cuda.is_available():
        print("control: CUDA is not available", file=sys.stderr)
        return 2
    cell = load_cell(args.workload)
    dev = torch.device("cuda", 0)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    cseeds = [int(s) for s in args.control_seeds.split(",") if s]
    lower, upper, control_failed = {}, {}, []
    for side, seed in [("program", s) for s in seeds] + [
            ("control", s) for s in cseeds]:
        if side == "program":
            got = program_readings(cell, seed, args.seconds, dev)
            for k, v in got.items():
                lower[k] = max(lower.get(k, v), v)
        else:
            got = control_readings(cell, seed, dev)
            for k, v in got.items():
                upper[k] = min(upper.get(k, v), v)
            control_failed.append(bool(fails(cell, got)))
        print(json.dumps({"workload": cell.name, "side": side, "seed": seed,
                          "readings": got, "over_limit": fails(cell, got)}),
              flush=True)
    print(json.dumps({"workload": cell.name, "lower": lower, "upper": upper,
                      "program_seeds": len(seeds),
                      "control_seeds": len(cseeds),
                      "every_control_failed": all(control_failed)
                      if control_failed else None,
                      "card": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
