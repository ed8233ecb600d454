# check: ignore-file[api-boundary]  (operator dev tool: inspects internals by design)
"""Multi-pod dry-run: trace every (arch x shape x mesh) cell on fake tensors.

The counterpart of ``repro.launch.dryrun``.  Proves the distribution
config is coherent without hardware: the production mesh is built over a
fake world of 256 or 512 ranks (``make_production_mesh``), the cell's
model is built at full width and depth under a
``FakeTensorMode`` (no parameter has storage), placed on the mesh (FSDP
above 8e9 parameters, ZeRO-1 for the optimiser state), and one step (the
train step with ``accum`` microbatches, ``prefill_step`` or
``serve_step``) runs on fake inputs (``launch.specs.input_specs``) under
``core.trace_cost.Counter``.  It writes the step's per-device counts and
their roofline terms on the H100 (``core.gpu_cost``: data-sheet rates,
not times taken on a card).

The process is the rank whose model coordinate is the last (rank m - 1 of
the row-major mesh: data, and pod, coordinates 0): where the heads do not
divide the model axis, attention splits its queries by sequence and the
causal mask leaves the last block of queries the most keys, so that rank
is the busiest; where they divide, every model rank does the same work.
The record says so (``rank``).

The dry-run is a trace, not a run on any device: it builds no kernel,
allocates no device memory and never starts the CUDA runtime (it checks
so before it writes a result).  Its fake tensors lie on the CPU, because
autograd records a CUDA tensor's stream, which reaches the CUDA runtime
even for a fake tensor; no count depends on the device.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3p2_3b \\
        --shape train_4k [--multi-pod] [--layout-mode coswitch] \\
        [--accum 8] [--out f.json]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --jobs 4

``--all`` runs every cell of ``configs.cells_for`` on both meshes, one
subprocess a cell, into ``results/dryrun_torch/<arch>-<shape>-{sp,mp}.json``
(or ``.err`` with the exception's last lines): a directory of its own, so
``benchmarks/roofline.py``, which reads ``repro``'s ``results/dryrun`` with
TPU constants, never reads these counts.
"""
import argparse
import json
import math
import pathlib
import subprocess
import sys
import tempfile
import time

from repro_torch import obs

log = obs.get_logger("dryrun")

#: where the dry-run's fake tensors lie (see the module docstring)
FAKE_DEVICE = "cpu"
#: the production mesh's model axis (``launch.mesh.make_production_mesh``)
MODEL_AXIS = 16


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _mesh(multi_pod: bool, shape=None):
    """The production mesh over a fake world, or a ``(data, model)`` mesh
    of ``shape`` over a fake world of that size; its groups made before
    any fake tensor exists."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.distributed import collectives as col
    from repro_torch.launch.mesh import init_fake_world, make_production_mesh
    if shape is None:
        init_fake_world(512 if multi_pod else 256, rank=MODEL_AXIS - 1)
        mesh = make_production_mesh(multi_pod=multi_pod, device=FAKE_DEVICE)
    else:
        init_fake_world(math.prod(shape), rank=shape[-1] - 1)
        mesh = init_device_mesh(FAKE_DEVICE, tuple(shape),
                                mesh_dim_names=("data", "model"))
    col.label_mesh(mesh)
    return mesh


def run_cell(arch: str, shape: str, multi_pod: bool = False,
             layout_mode: str = "coswitch", accum: int = 8, *,
             smoke: bool = False, mesh=None, cell=None) -> dict:
    """Trace one cell; returns its record.  ``smoke``, ``mesh`` (a
    ``(data, model)`` shape for a fake world of that size, in place of
    the production mesh) and ``cell`` (a ``ShapeCell`` in place of
    ``shape``'s) size a cell down for tests.  A process traces one cell:
    its fake world is the process's one process group."""
    import torch
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs import get_config
    from repro_torch.configs.base import shape_by_name
    from repro_torch.core import gpu_cost
    from repro_torch.core.trace_cost import Counter
    from repro_torch.distributed.stepfn import (data_rows, make_train_step,
                                                prefill_step, serve_step)
    from repro_torch.launch.specs import input_specs
    from repro_torch.models import build_model
    from repro_torch.optim import adamw_init

    cfg = get_config(arch, smoke)
    cell = cell or shape_by_name(shape)
    B, T = cell.global_batch, cell.seq_len
    dev_mesh = _mesh(multi_pod, mesh)
    t0 = time.time()
    with FakeTensorMode():
        model = build_model(cfg, device=FAKE_DEVICE)
        n_params = _tree_params(model)
        n_active = _tree_params(model, active_only=True)
        if cell.kind == "train":
            step = make_train_step(model, dev_mesh, layout_mode=layout_mode,
                                   accum=accum)
            opt = adamw_init(model.params())
            batch = input_specs(arch, shape, smoke, device=FAKE_DEVICE,
                                cell=cell)["batch"]
            state = [*opt.mu.values(), *opt.nu.values(),
                     *opt.master.values()]
            # repro's AdamW step counter: an int32 scalar argument
            args = _nbytes(model.params().values()) + _nbytes(state) + 4 \
                + _nbytes(data_rows(t, dev_mesh) for t in batch.values())
            with Counter() as counter:
                opt, _ = step(opt, batch)
            outs = _nbytes(model.params().values()) + _nbytes(state) + 4 \
                + 8                                   # loss and lr, f32
        else:
            specs = None
            if cell.kind == "prefill":
                fn = prefill_step(model, dev_mesh, B, T, T,
                                  frames=cfg.family == "encdec")
                specs = input_specs(arch, shape, smoke, device=FAKE_DEVICE,
                                    cell=cell)
                call = [specs["tokens"]] + (
                    [specs["frames"]] if "frames" in specs else [])
                local = [data_rows(t, dev_mesh) for t in call]
            else:
                fn = serve_step(model, dev_mesh, B, T)
                specs = input_specs(arch, shape, smoke, model=model,
                                    device=FAKE_DEVICE, cell=cell)
                call = [specs["cache"], specs["tokens"]]
                local = list(_leaves(specs["cache"])) + [
                    data_rows(specs["tokens"], dev_mesh)]
            args = _nbytes(model.params().values()) + _nbytes(local)
            with torch.no_grad(), Counter() as counter:
                cache, logits = fn(*call)
            outs = _nbytes(_leaves(cache)) + _nbytes([logits])
    trace_s = time.time() - t0
    if torch.cuda.is_initialized():
        raise RuntimeError("the dry-run started the CUDA runtime")
    counts = counter.counts
    chips = math.prod(dev_mesh.shape)
    terms = gpu_cost.terms_from_counts(
        counts.flops, counts.bytes, counts.collective_by_axis(), chips,
        dict(zip(dev_mesh.mesh_dim_names, dev_mesh.shape)))
    return {
        "arch": arch, "shape": shape,
        "mesh": "x".join(str(s) for s in dev_mesh.shape),
        "cell": {"kind": cell.kind, "global_batch": B, "seq_len": T},
        "layout_mode": layout_mode, "accum": accum,
        "device": f"fake {FAKE_DEVICE} tensors, no card",
        "rank": {"global": dist.get_rank(),
                 "model": dev_mesh.get_local_rank("model"),
                 "why": "the last model rank: the busiest under the causal "
                        "sequence split"},
        "trace_s": round(trace_s, 1), "chips": chips,
        "per_device": {"argument_bytes": args, "output_bytes": outs,
                       "peak_live_bytes": counts.peak_live_bytes},
        "flops_per_device": counts.total_flops,
        "flops_by_unit": dict(counts.flops),
        "bytes_per_device": counts.bytes,
        "collective_bytes_per_device": counts.collective_bytes,
        "collective_kinds": counts.collective_kinds,
        "kernels": counts.kernels,
        "ops": counts.ops,
        "roofline": terms.to_dict(),
        "n_params": n_params, "n_params_active": n_active,
    }


def _tree_params(model, active_only: bool = False) -> float:
    """Parameter count from the spec table; for MoE, active = top_k/E of
    the expert tensors (+ everything else): ``repro``'s ``_tree_params``
    on the port's names (an expert tensor is a layer's 3-D ``ffn`` leaf
    outside the shared expert, the 4-D stacked leaf of ``repro``)."""
    from repro_torch.models.lm import param_specs
    cfg = model.cfg
    total = expert = 0.0
    for name, (shape, _) in param_specs(cfg).items():
        n = float(math.prod(shape))
        total += n
        if len(shape) == 3 and ".ffn." in name and "shared" not in name:
            expert += n
    if not active_only or cfg.family != "moe" or not cfg.n_experts:
        return total
    return total - expert * (1.0 - cfg.top_k / cfg.n_experts)


# ------------------------------------------------------- the --all runner
def all_cells():
    from repro_torch.configs import ARCH_IDS, cells_for
    for arch in ARCH_IDS:
        for cell in cells_for(arch):
            yield arch, cell.name


def main() -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--layout-mode", default="coswitch",
                    choices=["coswitch", "fixed"])
    ap.add_argument("--accum", type=int, default=8)
    ap.add_argument("--out")
    ap.add_argument("--all", action="store_true",
                    help="run every assigned cell (both meshes) as subprocesses")
    ap.add_argument("--jobs", type=int, default=4)
    ap.add_argument("--results-dir", default="results/dryrun_torch")
    ap.add_argument("--log-level", default=None,
                    choices=["debug", "info", "warning", "error"],
                    help="console log threshold (default: REPRO_LOG or info)")
    args = ap.parse_args()

    obs.configure_from_env()          # REPRO_TRACE=path enables tracing
    if args.log_level:
        obs.set_level(args.log_level)

    if args.all:
        rdir = pathlib.Path(args.results_dir)
        rdir.mkdir(parents=True, exist_ok=True)
        jobs = []
        for arch, shape in all_cells():
            for mp in (False, True):
                tag = f"{arch}-{shape}-{'mp' if mp else 'sp'}"
                out = rdir / f"{tag}.json"
                if out.exists():
                    continue
                cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                       "--arch", arch, "--shape", shape, "--out", str(out),
                       "--layout-mode", args.layout_mode,
                       "--accum", str(args.accum)]
                if mp:
                    cmd.append("--multi-pod")
                jobs.append((tag, cmd))
        running = []
        while jobs or running:
            while jobs and len(running) < args.jobs:
                tag, cmd = jobs.pop(0)
                log.info("start %s", tag)
                err = tempfile.TemporaryFile()
                running.append((tag, err, subprocess.Popen(
                    cmd, stdout=subprocess.DEVNULL, stderr=err)))
            for job in [r for r in running if r[2].poll() is not None]:
                running.remove(job)
                tag, err, proc = job
                if proc.returncode == 0:
                    log.info("ok %s", tag)
                else:
                    log.error("FAIL %s", tag)
                    err.seek(0)
                    (rdir / f"{tag}.err").write_bytes(err.read()[-2000:])
                err.close()
            time.sleep(0.5)
        return

    result = run_cell(args.arch, args.shape, args.multi_pod,
                      args.layout_mode, args.accum)
    text = json.dumps(result, indent=2)
    print(text)
    if args.out:
        pathlib.Path(args.out).write_text(text)


if __name__ == "__main__":
    main()
