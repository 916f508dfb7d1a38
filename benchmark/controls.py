#!/usr/bin/env python3
"""Readings of a cell's numbers for the program and for its control, seed by
seed, to set and check the limits that decide ``correct``.

    python3 benchmark/controls.py --workload <cell> --seconds <s> --seeds <n> [<n> ...]

For each seed it runs the cell once (a short window is enough: the numbers
compared do not depend on its length) and prints one JSON line: the
program's numbers, and the control's on the same inputs: the plain
reference computed in fp8, the next precision below the configuration's
bf16, in the program's place; for a training cell also the faults of half of
each batch left out and of a step that returns its state unchanged, planted
in the reference put in the program's place. The control has to fail a limit
on every seed. Not part of a benchmark run: the runs do not compute the
control.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def readings(cell, seed: int, seconds: float, device) -> dict:
    """{"program": numbers, "control": numbers, "limits": limits} of one run."""
    import run
    from benchlib import cells

    ctx, out, result = run.run_cell(cell, seed=seed, seconds=seconds, trace=False,
                                    device=device, t_process=time.perf_counter())
    drv = cells.driver(cell)
    out_ = {"program": {k: v["value"] for k, v in result["checks"].items()},
            "control": drv.judge_control(ctx, out), "limits": cell.limits}
    if hasattr(drv, "judge_faults"):
        out_["faults"] = drv.judge_faults(ctx, out)
    return out_


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    sys.path[:0] = [HERE, ROOT]
    import torch

    from benchlib.cells import load_cell

    cell = load_cell(args.workload)
    for seed in args.seeds:
        r = readings(cell, seed, args.seconds, torch.device("cuda", 0))
        print(json.dumps({"workload": cell.name, "seed": seed, **r,
                          "card": torch.cuda.get_device_name(0)}), flush=True)


if __name__ == "__main__":
    main()
