"""Self-test: plant one violation per rule id and assert each is caught.

``python -m repro_torch.check smoke`` builds a throwaway tree containing
exactly one violation of every rule in ``repro_torch.check.RULES`` (plus a clean plan
artifact, a clean generated-doc block, and a pragma-suppressed violation),
runs the real checkers over it, and fails loudly if any rule goes
undetected, fires on the clean fixtures, or ignores its pragma.  This is
the guard against the classic linter failure mode — a checker that
silently stops matching and reports an evergreen "ok".
"""
from __future__ import annotations

import copy
import json
import pathlib
import tempfile
from typing import Dict, List

from . import RULES, Finding
from . import docs_gen, plan_lint

_BAD_SITES = '''\
from repro_torch.runtime import faults
from repro_torch.runtime.retry import retry_call


def f():
    faults.site("plan.lod")
    return retry_call(lambda: 0, site="plan.greedyy")
'''

_BAD_OBS = '''\
from repro_torch import obs


def g():
    obs.inc_counter("serve.requsts")
    obs.inc_counter("plan_cache.hit", tiers="mem")
    obs.inc_counter("totally.bogus")  # check: ignore[obs-unknown]
'''

_BAD_THREADS = '''\
import threading


class Worker:
    def start(self):
        self._t = threading.Thread(target=self._loop, daemon=True)
        self._t.start()

    def _loop(self):
        self.n = 1
'''

_BAD_APP = "from repro_torch.plan import ExecutionPlan\n"
_BAD_LAYER = "from repro_torch.serve import engine\n"


def _stub_module(block: str) -> str:
    return f'"""smoke fixture.\n\n{docs_gen.BEGIN}\n{block}\n{docs_gen.END}\n"""\n'


def _base_plan() -> Dict:
    """A minimal plan the linter accepts: 3 steps, one fused edge, one
    join, per-tensor ping-pong on a tiled step."""
    def step(i: int, in_l: str, out_l: str) -> Dict:
        return {"layer": f"L{i}", "workload": {}, "dataflow": {},
                "in_layout": in_l, "out_layout": out_l, "reorder": "none",
                "kernel": "rir_matmul", "epilogue_perm": None,
                "cycles": 1.0, "energy_pj": 1.0, "lowering": "gemm",
                "joins": [], "tiles": [["P", 2]], "double_buffer": False,
                "buffer_alloc": [], "fused_with": None,
                "dram_stall_cycles": 0.0}

    s0, s1, s2 = step(0, "A", "B"), step(1, "B", "B"), step(2, "B", "C")
    s0["fused_with"] = 1
    s1["buffer_alloc"] = ["iact", "w"]
    s2["joins"] = [{"src": 0, "src_layout": "B", "relayout": "offchip"}]
    return {"version": 4, "graph_name": "smoke", "graph_hash": "0" * 8,
            "config_key": "k", "objective": "cycles", "planner": "fixed",
            "total_cycles": 3.0, "total_energy_pj": 3.0,
            "transition_cycles": 0.0, "steps": [s0, s1, s2]}


def _plan_mutations() -> Dict[str, Dict]:
    """file stem -> mutated artifact, one per plan rule."""
    out: Dict[str, Dict] = {}

    p = _base_plan()
    p["version"] = 9
    out["bad_version"] = p

    p = _base_plan()
    p["steps"][0]["fused_with"] = 2          # skips the next step
    out["bad_fused"] = p

    p = _base_plan()
    p["steps"][1]["in_layout"] = "Z"
    out["bad_boundary"] = p

    p = _base_plan()
    p["steps"][2]["joins"][0]["src"] = 2     # self-reference
    out["bad_join"] = p

    p = _base_plan()
    p["steps"][1]["buffer_alloc"] = ["iact", "iact"]
    out["bad_alloc"] = p

    out["clean"] = _base_plan()
    return out


_PLANTED = {
    "site-unknown": "src/repro_torch/bad_sites.py",
    "obs-unknown": "src/repro_torch/bad_obs.py",
    "obs-label": "src/repro_torch/bad_obs.py",
    "thread-unguarded": "src/repro_torch/bad_threads.py",
    "api-boundary": "src/repro_torch/launch/bad_app.py",
    "layering": "src/repro_torch/core/bad_layer.py",
    "docs-drift": "src/repro_torch/obs/__init__.py",
    "plan-version": "plans/bad_version.json",
    "plan-fused-chain": "plans/bad_fused.json",
    "plan-boundary": "plans/bad_boundary.json",
    "plan-join": "plans/bad_join.json",
    "plan-buffer-alloc": "plans/bad_alloc.json",
}


def _build_tree(root: pathlib.Path) -> None:
    from repro_torch.runtime import faults

    files = {
        "src/repro_torch/bad_sites.py": _BAD_SITES,
        "src/repro_torch/bad_obs.py": _BAD_OBS,
        "src/repro_torch/bad_threads.py": _BAD_THREADS,
        "src/repro_torch/launch/bad_app.py": _BAD_APP,
        "src/repro_torch/core/bad_layer.py": _BAD_LAYER,
        # stale generated block -> docs-drift
        "src/repro_torch/obs/__init__.py": _stub_module("stale inventory"),
        # current generated block -> must stay clean
        "src/repro_torch/runtime/faults.py":
            _stub_module(faults.render_site_table()),
    }
    for rel, text in files.items():
        path = root / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(text)
    plans = root / "plans"
    plans.mkdir()
    for stem, doc in _plan_mutations().items():
        (plans / f"{stem}.json").write_text(json.dumps(doc))


def run() -> int:
    from .__main__ import run_source_checks

    failures: List[str] = []
    with tempfile.TemporaryDirectory(prefix="repro-torch-check-smoke-") as td:
        root = pathlib.Path(td)
        _build_tree(root)
        findings: List[Finding] = run_source_checks(root)
        findings += docs_gen.check_docs(root)
        findings += plan_lint.check_paths([root / "plans"], root)

        by_rule: Dict[str, List[Finding]] = {r: [] for r in RULES}
        for f in findings:
            by_rule.setdefault(f.rule, []).append(f)

        for rule, rel in _PLANTED.items():
            hits = [f for f in by_rule[rule] if f.file == rel]
            if not hits:
                failures.append(
                    f"planted {rule} violation in {rel} was NOT caught")
        for f in findings:
            if f.file == "plans/clean.json":
                failures.append(f"clean plan fixture misflagged: "
                                f"{f.format()}")
            if f.file == "src/repro_torch/runtime/faults.py":
                failures.append(f"current generated block misflagged: "
                                f"{f.format()}")
            if "totally.bogus" in f.message:
                failures.append(f"pragma-suppressed finding leaked: "
                                f"{f.format()}")
        unknown = [f for f in findings if f.rule not in RULES]
        if unknown:
            failures.append(f"findings with unregistered rule ids: "
                            f"{[f.rule for f in unknown]}")

    if failures:
        for msg in failures:
            print(f"[check.smoke] FAIL: {msg}")
        return 1
    print(f"[check.smoke] ok: {len(_PLANTED)} planted violations "
          f"({len(RULES)} rules) all caught; clean fixtures clean; "
          f"pragma respected")
    return 0


if __name__ == "__main__":
    raise SystemExit(run())
