# check: ignore-file[api-boundary]  (operator dev tool: inspects internals by design)
"""The port's reader of its dry-run: one roofline row a cell.

The counterpart of ``benchmarks/roofline.py``, which reads ``repro``'s
``results/dryrun`` with TPU constants; this one reads the port's
``results/dryrun_torch/*.json`` (``repro_torch.launch.dryrun --all``) with
the H100's (``core.gpu_cost``).  A row holds, for the device the record
counts:

* the three roofline terms (compute, memory, collective), each re-priced
  here from the record's counts on ``gpu_cost``'s rates (so a record
  written before a rate changed reads at today's), the dominant term and
  the bound;
* ``model_flops``: ``gpu_cost.model_flops`` of the cell (6 N_active
  tokens for a train step, 2 N_active tokens for prefill or one decode
  step) over the mesh's devices, and its ratio to the FLOPs the record
  counted (1.0: every counted operation is the model's own);
* fp32 FLOPs against bf16 (the CUDA cores' share of the work);
* peak live bytes against the card's 80 GB.

Every number is a count on fake tensors priced on data-sheet rates, not a
time taken on a card.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.roofline \\
        [--dir results/dryrun_torch] [--json rows.json]
"""
from __future__ import annotations

import argparse
import json
import pathlib
from typing import Dict, List

#: device memory of one H100 SXM5 80GB (bytes)
HBM_CAPACITY = 80e9


def _mesh_shape(mesh: str) -> Dict[str, int]:
    sizes = [int(s) for s in mesh.split("x")]
    names = ("pod", "data", "model")[-len(sizes):]
    return dict(zip(names, sizes))


def row(rec: dict) -> dict:
    """One cell's row from its dry-run record."""
    from repro_torch.configs.base import shape_by_name
    from repro_torch.core import gpu_cost
    from repro_torch.core.trace_cost import Counts
    cell = rec.get("cell") or vars(shape_by_name(rec["shape"]))
    by_axis = Counts(collective_kinds=rec["collective_kinds"]
                     ).collective_by_axis()
    terms = gpu_cost.terms_from_counts(
        rec["flops_by_unit"], rec["bytes_per_device"], by_axis,
        rec["chips"], _mesh_shape(rec["mesh"]))
    train = cell["kind"] == "train"
    tokens = cell["global_batch"] * (1 if cell["kind"] == "decode"
                                     else cell["seq_len"])
    mf = gpu_cost.model_flops(rec["n_params_active"], tokens,
                              train) / rec["chips"]
    flops = rec["flops_per_device"]
    fp32 = rec["flops_by_unit"].get("fp32", 0.0)
    bf16 = rec["flops_by_unit"].get("bf16", 0.0)
    peak = rec["per_device"]["peak_live_bytes"]
    return {"arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"],
            "rank": rec.get("rank", {}).get("model"),
            "compute_s": terms.compute_s, "memory_s": terms.memory_s,
            "collective_s": terms.collective_s,
            "collective_s_by_axis": dict(terms.collective_s_by_axis),
            "dominant": terms.dominant, "bound_s": terms.bound_s,
            "flops": flops, "model_flops": mf,
            "model_flops_ratio": mf / flops if flops else 0.0,
            "fp32_flops": fp32, "bf16_flops": bf16,
            "fp32_share": fp32 / flops if flops else 0.0,
            "collective_bytes": rec["collective_bytes_per_device"],
            "peak_live_bytes": peak,
            "peak_share_of_hbm": peak / HBM_CAPACITY,
            "argument_bytes": rec["per_device"]["argument_bytes"]}


def rows(directory) -> List[dict]:
    """A row for every record in ``directory``, by (arch, shape, mesh)."""
    out = [row(json.loads(p.read_text()))
           for p in sorted(pathlib.Path(directory).glob("*.json"))]
    return sorted(out, key=lambda r: (r["arch"], r["shape"], r["mesh"]))


def table(rs: List[dict]) -> str:
    """The rows as a markdown table (seconds on the data-sheet rates)."""
    head = ("| cell | mesh | compute s | memory s | collective s | bound | "
            "TFLOP | model TFLOP | ratio | fp32 TFLOP | collective GB | "
            "peak GB / 80 |")
    lines = [head, "|" + "---|" * (head.count("|") - 1)]
    for r in rs:
        lines.append(
            f"| {r['arch']} `{r['shape']}` | {r['mesh']} | "
            f"{r['compute_s']:.4g} | {r['memory_s']:.4g} | "
            f"{r['collective_s']:.4g} | {r['dominant']} {r['bound_s']:.4g} | "
            f"{r['flops'] / 1e12:.4g} | {r['model_flops'] / 1e12:.4g} | "
            f"{r['model_flops_ratio']:.3f} | {r['fp32_flops'] / 1e12:.4g} | "
            f"{r['collective_bytes'] / 1e9:.4g} | "
            f"{r['peak_live_bytes'] / 1e9:.3g} "
            f"({r['peak_share_of_hbm']:.2f}) |")
    return "\n".join(lines)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.roofline")
    ap.add_argument("--dir", default="results/dryrun_torch")
    ap.add_argument("--json", default=None, help="also write the rows here")
    args = ap.parse_args(argv)
    rs = rows(args.dir)
    print(table(rs))
    if args.json:
        pathlib.Path(args.json).write_text(json.dumps(rs, indent=1))


if __name__ == "__main__":
    main()
