"""Run one cell of the benchmark once and print its result.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks for.
It drives ``repro_torch`` (``src/repro_torch``) and nothing of the JAX
package.  The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1`` a
``breakdown``, and last ``check``: each number the correctness check
compared, beside its limit.  The last lines of standard error give the same
numbers.  Exit codes: 0 a result was printed; 1 the run failed; 3 no CUDA
or too few cards; 4 a JAX module was loaded.
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys
import time
import traceback

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


def _environment() -> None:
    """Caches at fixed paths inside the checkout; the program's own tracing
    left off (it fences every layer)."""
    cache = HERE / "cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(cache / sub)
    os.environ.pop("REPRO_TRACE", None)
    for p in (str(ROOT / "src"), str(HERE)):
        if p not in sys.path:
            sys.path.insert(0, p)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0 or args.seconds <= 0:
        ap.error("--seed must be >= 0 and --seconds > 0")
    _environment()
    t_main = time.perf_counter()

    from bench import cell as cell_mod
    from bench.spec import find_cell

    t_start = cell_mod.process_start()
    stamps = [("interpreter", t_main),
              ("torch import", time.perf_counter())]
    cell = find_cell(args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"needs {cell.chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    stamps.append(("cuda start", time.perf_counter()))
    try:
        out = cell_mod.run(cell, args.seed, args.seconds, bool(args.trace),
                           t_start=t_start, stamps=stamps)
    except Exception:   # noqa: BLE001 — report the run's failure, no result
        traceback.print_exc()
        return 1
    bad = cell_mod.forbidden_modules()
    if bad:
        print(f"JAX or the JAX package was loaded: {bad}", file=sys.stderr)
        return 4
    for n in out.notes:
        print(n, file=sys.stderr)
    for k, v in out.checks.items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    result = {"correct": out.correct, "attempted": out.attempted,
              "failed": out.failed, "metrics": out.metrics,
              "device": out.device}
    if out.breakdown is not None:
        result["breakdown"] = out.breakdown
    result["check"] = out.checks
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
