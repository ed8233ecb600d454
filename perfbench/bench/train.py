"""One run of a training cell: a configuration of ``"kind": "lm_train"``
under a traffic mix of ``"kind": "train"``.

The configuration names the port's architecture (``arch``, with
``overrides`` of its fields) and its own model module (``model``, a path
under the checkout): the plain reference and the count, loaded by path
(``model_module``).  The traffic mix gives the step: ``sequences`` of
``tokens`` tokens, the constant learning rate ``lr``, ``setup_steps``, of
which the reference follows the first ``checked_steps``, and a ``pool``
of batches, uniform token ids drawn from the seed on the device.

Set-up builds one training step on the port's normal path, as its
launcher does (``api.get_config`` with the overrides, ``build_model``,
``adamw_init``, ``make_train_step``), after checking that the port's model
is the one the reference computes.  The weights are the benchmark's: drawn
from the seed on the device in two calls (one per dtype) under the model
module's ``init``, and copied in.  The step is then driven through the
first ``setup_steps`` batches: they build and warm every kernel and shape
of the window, and the first ``checked_steps`` of them are the steps the
reference follows.  Between them the program's own readings are taken:
the norm of each leaf's first gradient as AdamW got it (its first moment
after one step, over 1 - b1) and, after the last checked step, of each
leaf's change from the drawn weights as AdamW keeps it for the next step (its f32 master: the bf16 parameters are the
master rounded, and a step of 2e-3 moves a weight near 1 by 0, 1 or 2 of
bf16's steps there).

The window runs the same step back to back, each ending on its loss on the
host (the step's one sync), for ``seconds``; ``train_tokens_per_s`` counts
the tokens of the whole steps from the last step end before the window
opened to the last one inside it, over the seconds between those ends.
With ``--trace`` the profiler takes whole steps after the window closes;
the readers divide their device times by those steps and their seconds
(the card paces them, traced or not: a step's host work hides under its
device work), and ``train.mfu_pct`` takes the window's own untraced step
rate (``Context.window_steps_per_s``).

Once the window has closed and the peak memory is read, the program is
freed and the reference follows the set-up's steps from the same drawn
weights (made again from the seed) in fp32, TF32 off, with AdamW in
plain ``torch``; ``correct`` compares each step's loss, each leaf's first
gradient norm and each leaf's change norm (``gaps``).
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import importlib.util
import math
import pathlib
import re
import resource
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .cell import Outcome, answered, process_start, warm_profiler
from .spec import ROOT, Cell

#: the traced steps, after the window: as many whole untraced steps as
#: fill this many seconds, at least one (the profiler records every host
#: op, and a step of the port's scan backward launches tens of thousands:
#: the trace of one step is large, and where the host paces a step the
#: profiler slows it, so traced steps are kept out of the measured window)
TRACE_S = 5.0
#: a leaf whose first reference gradient is under this share of the
#: median leaf's moves under AdamW by round-off alone: left out of the
#: change's comparison
STILL = 1e-3


def model_module(config: dict):
    """The configuration's model module, loaded from its path."""
    path = pathlib.Path(config["model"])
    path = path if path.is_absolute() else ROOT / path
    name = "perfbench_model_" + re.sub(r"\W", "_", path.stem)
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def step_rate(ends: List[float], a: float, b: float) -> Tuple[int, float]:
    """Steps completed in the window [a, b], as (steps, seconds): the whole
    steps from the last step end at or before ``a`` to the last at or
    before ``b``, and the seconds between those two ends (``answered``
    with each step a burst of one)."""
    return answered(ends, a, b, gap=0.0)


# ------------------------------------------------------------------ set-up
def generator(seed: int, stream: int, device: str) -> torch.Generator:
    """A generator on ``device`` for one stream of the seed: 0 the weights,
    1 the token ids."""
    sub = np.random.SeedSequence([seed, stream]).generate_state(1, np.uint64)
    return torch.Generator(device=device).manual_seed(int(sub[0]))


def draw_weights(config: dict, mod, seed: int, device: str
                 ) -> Dict[str, torch.Tensor]:
    """Every parameter of ``mod.param_shapes``, drawn from ``seed`` on
    ``device`` in one call a dtype (in the order of the shapes) and set to
    ``mean + std * z`` by ``mod.init``, in its own dtype."""
    shapes = mod.param_shapes(config)
    g = generator(seed, 0, device)
    out: Dict[str, torch.Tensor] = {}
    for dt in sorted({d for _, d in shapes.values()}):
        names = [n for n, (_, d) in shapes.items() if d == dt]
        sizes = [math.prod(shapes[n][0]) for n in names]
        flat = torch.randn(sum(sizes), generator=g, device=device,
                           dtype=getattr(torch, dt))
        o = 0
        for n, size in zip(names, sizes):
            mean, std = mod.init(config, n, shapes[n][0])
            out[n] = flat[o:o + size].view(shapes[n][0]).mul_(std).add_(mean)
            o += size
    return out


def draw_pool(config: dict, traffic: dict, seed: int, device: str
              ) -> torch.Tensor:
    """``pool`` batches of ``sequences`` x (``tokens`` + 1) token ids,
    uniform over the vocabulary, from the seed's token stream."""
    g = generator(seed, 1, device)
    return torch.randint(0, config["vocab"],
                         (traffic["pool"], traffic["sequences"],
                          traffic["tokens"] + 1),
                         generator=g, device=device)


def port_config(config: dict):
    """The port's config of the configuration: ``api.get_config(arch)``
    with its ``overrides``."""
    from repro_torch import api
    return dataclasses.replace(api.get_config(config["arch"]),
                               **config.get("overrides", {}))


@dataclasses.dataclass
class Program:
    """The one training step the run drives, set-up and window alike: a
    fault test replaces ``step`` (``hook``)."""

    model: torch.nn.Module
    opt: object
    step: Callable


def build_program(config: dict, traffic: dict, mod, seed: int,
                  device: str) -> Program:
    from repro_torch import api

    cfg = port_config(config)
    differ = {k: (config[k], getattr(cfg, k)) for k in mod.PORT_KEYS
              if config[k] != getattr(cfg, k)}
    if differ:
        raise RuntimeError(f"the port's {config['arch']} is not the "
                           f"configuration (file, port): {differ}")
    model = api.build_model(cfg, device=device)
    own = model.params()
    shapes = mod.param_shapes(config)
    got = {n: (tuple(p.shape), str(p.dtype).removeprefix("torch."))
           for n, p in own.items()}
    if got != {n: (tuple(s), d) for n, (s, d) in shapes.items()}:
        raise RuntimeError("the port's parameters are not the reference's: "
                           f"{sorted(set(got) ^ set(shapes))[:5]} or shapes")
    weights = draw_weights(config, mod, seed, device)
    model.load_params(weights)
    del weights
    opt = api.adamw_init(model.params())
    step = api.make_train_step(model, lr=traffic["lr"])
    return Program(model=model, opt=opt, step=step)


def leaf_norms(tensors) -> np.ndarray:
    """Each tensor's L2 norm in f32, in order, read in one copy."""
    return torch.stack([torch.linalg.vector_norm(t.float())
                        for t in tensors]).cpu().numpy().astype(np.float64)


@dataclasses.dataclass
class Readings:
    """What a side gives over the checked steps: each step's loss, each
    leaf's first gradient norm and its change norm after the last checked
    step, leaves in the order of the model module's ``param_shapes``."""

    losses: List[float]
    grad: np.ndarray
    change: np.ndarray


def program_readings(prog: Program, config: dict, mod, pool: torch.Tensor,
                     steps: int, checked: int, seed: int, device: str,
                     ends: List[float], losses: List[float]) -> Readings:
    """Drive ``prog`` through the first ``steps`` batches of ``pool``
    (each step's end and loss appended to ``ends`` and ``losses``),
    reading its state over the first ``checked``."""
    names = list(mod.param_shapes(config))
    b1 = config["optimizer"]["b1"]
    first = len(losses)
    grad = change = None
    for i in range(steps):
        one_step(prog, pool, i, ends, losses)
        if i == 0:
            grad = leaf_norms(prog.opt.mu[n] for n in names) / (1.0 - b1)
        if i == checked - 1:
            start = draw_weights(config, mod, seed, device)
            change = leaf_norms(prog.opt.master[n] - start[n].float()
                                for n in names)
            del start
    return Readings(losses=list(losses[first:first + checked]), grad=grad,
                    change=change)


def one_step(prog: Program, pool: torch.Tensor, i: int, ends: List[float],
             losses: List[float]) -> None:
    prog.opt, m = prog.step(prog.opt, {"tokens": pool[i % len(pool)]})
    losses.append(float(m["loss"]))
    ends.append(time.perf_counter())


# --------------------------------------------------------------- reference
@contextlib.contextmanager
def fp32_products():
    """fp32 products with TF32 off, the flags restored after."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def reference_readings(config: dict, traffic: dict, mod, seed: int,
                       device: str, batches: torch.Tensor,
                       precision: str = "fp32",
                       rows: Optional[int] = None) -> Readings:
    """The plain reference through ``batches`` (one a step) from the drawn
    weights: the model module's loss and gradients in ``precision``, and
    AdamW's expression (``config["optimizer"]``) in f32 at the traffic's
    learning rate.  ``rows``: only each batch's first ``rows`` sequences
    (a fault: part of the batch left out)."""
    o = config["optimizer"]
    b1, b2, eps, wd = o["b1"], o["b2"], o["eps"], o["weight_decay"]
    lr = traffic["lr"]
    with fp32_products():
        start = draw_weights(config, mod, seed, device)
        names = list(mod.param_shapes(config))
        p = {n: start[n].float() for n in names}
        m = {n: torch.zeros_like(t) for n, t in p.items()}
        v = {n: torch.zeros_like(t) for n, t in p.items()}
        losses, grad = [], {}
        for s, tokens in enumerate(batches, 1):
            loss, g = mod.loss_and_grads(config, p, tokens[:rows], precision)
            losses.append(loss)
            with torch.no_grad():
                norm = math.sqrt(sum(float(torch.sum(t * t))
                                     for t in g.values()))
                clip = min(1.0, o["max_grad_norm"] / (norm + 1e-9))
                for n in names:
                    gn = g.pop(n) * clip
                    if s == 1:
                        grad[n] = gn.norm()
                    m[n].mul_(b1).add_(gn, alpha=1 - b1)
                    v[n].mul_(b2).addcmul_(gn, gn, value=1 - b2)
                    upd = (m[n] / (1 - b1 ** s)) / \
                        (torch.sqrt(v[n] / (1 - b2 ** s)) + eps)
                    p[n] = p[n] - lr * (upd + wd * p[n])
                    del gn, upd
        change = leaf_norms(p[n] - start[n].float() for n in names)
    return Readings(losses=losses,
                    grad=leaf_norms(grad[n] for n in names), change=change)


def worst_leaf(got: np.ndarray, want: np.ndarray) -> float:
    """The largest gap between two sides' leaf norms, each over the
    reference's norm of that leaf or of the median leaf, whichever is
    larger."""
    floor = float(np.median(want))
    return float(np.max(np.abs(got - want) / np.maximum(want, floor)))


def gaps(got: Readings, want: Readings) -> Dict[str, float]:
    """The worst step's loss gap over the reference's loss, and the worst
    leaf's gap of its first gradient norm and of its change norm (leaves
    the reference moves by round-off alone left out of the change:
    ``STILL``).  ``correct`` compares those the configuration gives a
    limit (``checks``)."""
    if len(got.losses) != len(want.losses):
        return {"loss_gap": math.inf, "grad_norm_gap": math.inf,
                "change_norm_gap": math.inf}
    moved = want.grad >= STILL * float(np.median(want.grad))
    a, b = np.array(got.losses), np.array(want.losses)
    out = {"loss_gap": float(np.max(np.abs(a - b) / np.abs(b))),
           "grad_norm_gap": worst_leaf(got.grad, want.grad),
           "change_norm_gap": worst_leaf(got.change[moved],
                                         want.change[moved])}
    return {k: v if math.isfinite(v) else math.inf for k, v in out.items()}


def checks(config: dict, measured: Dict[str, float], nonfinite: int,
           steps: int) -> Tuple[Dict[str, dict], bool]:
    """Each number the configuration gives a limit beside it (a gap at most
    its limit, ``steps_checked`` at least its), and whether every one
    holds."""
    lim = config["limits"]
    out = {k: {"value": v, "limit": lim[k]} for k, v in measured.items()
           if k in lim}
    out["nonfinite_losses"] = {"value": nonfinite, "limit": 0}
    out["steps_checked"] = {"value": steps, "limit": lim["steps_checked"]}
    ok = all(v <= lim[k] for k, v in measured.items() if k in lim) \
        and nonfinite == 0 and steps >= lim["steps_checked"]
    return out, ok


# ------------------------------------------------------------------ the run
def run(cell: Cell, seed: int, seconds: float, trace: bool,
        device: str = "cuda", t_start: Optional[float] = None,
        hook: Optional[Callable] = None,
        stamps: Optional[List[Tuple[str, float]]] = None) -> Outcome:
    """Run the training cell once.  ``hook(program)``, if given, is called
    once the step is built (the fault tests plant their faults there);
    ``stamps`` are (phase, end) times of the set-up before the call."""
    from .context import Context

    t_start = process_start() if t_start is None else t_start
    config, tr = cell.config, cell.traffic
    mod = model_module(config)
    cuda = device.startswith("cuda")
    notes: List[str] = []
    stamps = [("process start", t_start)] + list(stamps or []) + \
        [("set-up's start", time.perf_counter())]
    prog = build_program(config, tr, mod, seed, device)
    pool = draw_pool(config, tr, seed, device)
    stamps.append(("model, weights and optimizer", time.perf_counter()))
    if hook is not None:
        hook(prog)
    if trace:
        warm_profiler()
    S, K = tr["setup_steps"], tr["checked_steps"]
    ends: List[float] = [time.perf_counter()]
    losses: List[float] = []
    mine = program_readings(prog, config, mod, pool, S, K, seed, device,
                            ends, losses)
    if cuda:
        torch.cuda.synchronize()
    stamps.append((f"{S} set-up steps", time.perf_counter()))
    notes.append("set-up step s: " + ", ".join(
        f"{b - a:.3f}" for a, b in zip(ends, ends[1:])))
    ends.pop(0)

    ru0 = resource.getrusage(resource.RUSAGE_SELF)
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    t_end = t0 + seconds
    notes.append("set-up s: " + ", ".join(
        f"{name} {b - a:.3f}" for (_, a), (name, b)
        in zip(stamps, stamps[1:] + [("to the window", t0)])))
    i = S
    while time.perf_counter() < t_end:
        one_step(prog, pool, i, ends, losses)
        i += 1
    ru1 = resource.getrusage(resource.RUSAGE_SELF)
    notes.append(f"host in the window: user "
                 f"{ru1.ru_utime - ru0.ru_utime:.3f} s, sys "
                 f"{ru1.ru_stime - ru0.ru_stime:.3f} s")
    n, secs = step_rate(ends, t0, t_end)
    prof = n_traced = None
    if trace:
        step_s = secs / n if n else ends[-1] - ends[-2]
        n_traced = max(1, int(min(TRACE_S, seconds / 2) / step_s))
        prof = traced_steps(prog, pool, i, n_traced, ends, losses)
    if cuda:
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
    else:
        peak = 0
    nonfinite = sum(1 for x in losses if not math.isfinite(x))
    notes.append(f"window: {n} steps in {secs!r} s; steps run {len(ends)};"
                 f" losses {losses[0]:.4f} .. {losses[-1]:.4f}")
    del prog
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    ref = reference_readings(config, tr, mod, seed, device, pool[:K])
    measured = gaps(mine, ref)
    still = int(np.sum(ref.grad < STILL * np.median(ref.grad)))
    notes.append(f"reference: {time.perf_counter() - t_ref:.3f} s; losses "
                 f"program {mine.losses} reference {ref.losses}; gaps "
                 f"{measured}; leaves left out of the change {still} of "
                 f"{len(ref.grad)}")
    check, correct = checks(config, measured, nonfinite, K)

    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name() if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    breakdown = None
    if trace:
        from . import trace as trace_mod
        tr_s = trace_mod.export_and_read(prof)
        tr_s.steps = float(n_traced)
        metrics = Context(cell=cell, trace=tr_s, batch=tr["sequences"],
                          window_steps_per_s=n / secs if secs > 0 else None
                          ).per_layer()
        dev["busy_s"] = tr_s.busy_s()
        dev["window_s"] = tr_s.window_s
        breakdown = {"device_ops": tr_s.top_ops(),
                     "idle_gaps": tr_s.top_gaps()}
        notes.append(f"traced: {tr_s.steps} steps in {tr_s.window_s!r} s, "
                     f"busy {tr_s.busy_s()!r} s, {len(tr_s.events)} "
                     f"device events; device ranges " + ", ".join(
                         f"{k} {v}" for k, v in collections.Counter(
                             n for n, _, _ in tr_s.ranges).most_common(8)))
    else:
        units = {m["name"]: m["unit"] for m in cell.end_to_end}
        e2e = {"train_tokens_per_s": tr["sequences"] * tr["tokens"] * n
               / secs if secs > 0 else 0.0, "setup_s": setup_s}
        metrics = {k: {"value": v, "unit": units[k]} for k, v in e2e.items()
                   if k in units}
    return Outcome(attempted=len(losses), failed=nonfinite, checks=check,
                   correct=correct, metrics=metrics, device=dev,
                   breakdown=breakdown, notes=notes)


def traced_steps(prog: Program, pool: torch.Tensor, i: int, n: int,
                 ends: List[float], losses: List[float]):
    """``n`` whole steps under the profiler, inside the range that bounds
    the traced sub-window; the stopped profile.  The profiler was started
    once in set-up (``warm_profiler``), so the first traced step runs as
    the others do."""
    from torch.profiler import profile, record_function

    from .cell import _activities
    from .trace import RANGE

    prof = profile(activities=_activities())
    prof.start()
    with record_function(RANGE):
        for j in range(n):
            one_step(prog, pool, i + j, ends, losses)
    prof.stop()
    return prof
