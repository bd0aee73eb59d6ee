"""Run one cell of BENCHMARK.json once, on this machine's CUDA card.

    python3 valetbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  Set-up (imports, the CUDA context, the
kernels from ``build/kernels/``, weights from the seed, the engine and the
warm-up steps), then a window of ``--seconds``; with ``--trace 1`` a few
profiled steps after it.  Then the port's state is freed and the check
runs.  The record goes to standard error, the numbers compared with their
limits last; the last line of standard output is the result's JSON.
Exits 2 without a CUDA card or the port beside it, and 3 if JAX, the JAX
package or the old ``benchmarks`` folder got loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def prepare() -> None:
    """The port and this folder on the path; every build and kernel cache
    of the run inside the checkout, at fixed paths."""
    for p in (str(ROOT), str(ROOT / "src")):
        if p not in sys.path:
            sys.path.insert(0, p)
    cache = ROOT / "build" / "valetbench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["USE_FLAX"] = "0"


def err(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    prepare()
    if not (ROOT / "src" / "repro_torch").is_dir():
        err(f"no port at {ROOT / 'src' / 'repro_torch'}: nothing to measure")
        return 2
    from valetbench.harness.spec import load_cell
    cell = load_cell(args.workload)
    import torch
    need = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        err(f"needs {need} CUDA device(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    from valetbench.harness.imports import loaded
    from valetbench.harness.runner import check_lines, run_cell
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                   T_START, log=err)
    bad = loaded()
    if bad:
        err(f"loaded what the benchmark may not: {', '.join(bad)}")
        return 3
    for line in check_lines(out["checked"]):
        err(line)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
