"""Readings for a cell's correctness limit: the program's widest gap and
the fp8 control's, on several seeds in one process.

    python3 valetbench/calibrate.py --workload <cell> --seeds 1,2,3 --seconds <s>

Each seed is a whole run (weights, engine, warm-up, a window of
``--seconds``, the check) whose result line also carries, per sampled
request, the served tokens' widest gap and the control's: the reference
in fp8 at the same positions (``check.gaps``), and the control's own
``correct`` from the harness's comparison with the cell's limits
(``check.verdict``), which has to read false.  One JSON line per seed on
standard output.  The benchmark's own runs never run the control.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))
from run import err, prepare  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args()
    prepare()
    import torch
    from valetbench.harness.imports import loaded
    from valetbench.harness.runner import check_lines, run_cell
    from valetbench.harness.spec import load_cell
    if not torch.cuda.is_available():
        err("needs a CUDA device")
        return 2
    cell = load_cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        out = run_cell(cell, seed, args.seconds, False, "cuda", t0, control=True,
                       log=err)
        ctl = out.pop("control")
        line = {"seed": seed, "correct": out["correct"],
                "served_gap": max(ctl["served_gap"].values()),
                "control_gap": max(ctl["control_gap"].values()),
                "control_correct": ctl["correct"],
                "control_checked": ctl["checked"],
                "per_request": [[g, ctl["control_gap"][r]]
                                for r, g in ctl["served_gap"].items()],
                "metrics": {k: v["value"] for k, v in out["metrics"].items()},
                "memory_peak_bytes": out["device"]["memory_peak_bytes"],
                "wall_s": time.perf_counter() - t0}
        for text in check_lines(ctl["checked"]):
            err(f"control seed {seed}: {text}")
        err(f"control seed {seed}: correct {ctl['correct']}")
        print(json.dumps(line), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    bad = loaded()
    if bad:
        err(f"loaded what the benchmark may not: {', '.join(bad)}")
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
