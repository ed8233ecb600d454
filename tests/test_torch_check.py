"""The port's static checks (``repro_torch.check``) against ``repro.check``.

The plan linter gives ``repro``'s rule ids for every mutation of
``tests/test_check.py`` (one invariant corrupted at a time on a copy of
``plan_mobilenet_v3.json``); the twelve rule ids are ``repro``'s; the
mirrored constants equal the port's own; the source linters catch their
planted violations on the port's paths and the pragma silences them;
``python -m repro_torch.check smoke`` catches every rule; and ``python -m
repro_torch.check`` passes on the tree without importing torch.
"""
import copy
import json
import os
import pathlib
import subprocess
import sys

import pytest

from repro import check as jcheck
from repro.check import plan_lint as jplan_lint
from repro_torch import check
from repro_torch.check import (api_lint, plan_lint, registry_lint, smoke,
                               thread_lint)
from repro_torch.core.dataflow import BUFFER_TENSORS
from repro_torch.plan.plan import COMPAT_VERSIONS

GOLDENS = pathlib.Path(__file__).parent / "goldens"
REPO = pathlib.Path(__file__).resolve().parents[1]


def _golden(name):
    return json.loads((GOLDENS / name).read_text())


def _rules(findings):
    return {f.rule for f in findings}


def test_plan_lint_mirrors_the_ports_constants():
    assert plan_lint.COMPAT_VERSIONS == COMPAT_VERSIONS
    assert plan_lint.BUFFER_TENSORS == BUFFER_TENSORS


def test_rule_ids_are_repros():
    assert set(check.RULES) == set(jcheck.RULES)
    assert set(smoke._PLANTED) == set(check.RULES)


# ------------------------------------------------------- mutation tests
def _v2_with_alloc(doc):
    doc["version"] = 2
    for s in doc["steps"]:
        for k in ("double_buffer", "buffer_alloc", "fused_with",
                  "dram_stall_cycles"):
            s.pop(k, None)
    doc["steps"][0]["buffer_alloc"] = ["iact"]


def _set(path, value):
    def mutate(doc):
        node = doc
        for key in path[:-1]:
            node = node[key]
        node[path[-1]] = value
    return mutate


def _last_fused(doc):
    n = len(doc["steps"])
    doc["steps"][n - 1]["fused_with"] = n


def _alloc_and_double(doc):
    assert doc["steps"][1]["buffer_alloc"]
    doc["steps"][1]["double_buffer"] = True


MUTATIONS = {
    "bad_version": _set(("version",), 99),
    "field_from_future_version": _v2_with_alloc,
    "broken_fuse_chain": _set(("steps", 3, "fused_with"), 6),
    "last_step_fused": _last_fused,
    "boundary_discontinuity": _set(("steps", 2, "in_layout"), "ZZZ_BOGUS"),
    "join_forward_reference": _set(("steps", 5, "joins", 0, "src"), 7),
    "join_layout_mismatch": _set(("steps", 5, "joins", 0, "src_layout"),
                                 "ZZZ_BOGUS"),
    "alloc_unknown_tensor": _set(("steps", 1, "buffer_alloc"),
                                 ["iact", "bogus"]),
    "alloc_duplicate": _set(("steps", 1, "buffer_alloc"), ["iact", "iact"]),
    "alloc_all_three_unnormalized": _set(("steps", 1, "buffer_alloc"),
                                         ["iact", "w", "oact"]),
    "alloc_conflicts_with_double_buffer": _alloc_and_double,
}


@pytest.mark.parametrize("name", sorted(MUTATIONS))
def test_mutation_gives_repros_rule(name):
    doc = _golden("plan_mobilenet_v3.json")
    MUTATIONS[name](doc)
    want = _rules(jplan_lint.check_plan(copy.deepcopy(doc), "m"))
    assert len(want) == 1
    assert _rules(plan_lint.check_plan(doc, "m")) == want


@pytest.mark.parametrize("name", sorted(
    p.name for p in GOLDENS.glob("*.json")
    if p.name != "tile_dram_pr4_fixture.json"))
def test_goldens_lint_clean(name):
    doc = _golden(name)
    assert plan_lint.looks_like_plan(doc)
    assert plan_lint.check_plan(doc, name) == []


# ------------------------------------------------------- source linters
def test_registry_lint_flags_the_ports_names():
    src = ('from repro_torch.runtime import faults\n'
           'from repro_torch import obs\n'
           'faults.site("plan.lod")\n'
           'obs.inc_counter("serve.requsts")\n'
           'obs.inc_counter("plan_cache.hit", tiers="mem")\n')
    assert _rules(registry_lint.check_source(
        src, "src/repro_torch/x.py")) == {"site-unknown", "obs-unknown",
                                          "obs-label"}


def test_api_lint_on_the_ports_layers():
    deep = 'from repro_torch.plan import ExecutionPlan\n'
    assert _rules(api_lint.check_source(
        deep, "src/repro_torch/launch/foo.py")) == {"api-boundary"}
    assert api_lint.check_source(deep, "src/repro_torch/serve/foo.py") == []
    ok = 'from repro_torch.api import build_model\nfrom repro_torch import obs\n'
    assert api_lint.check_source(ok, "src/repro_torch/launch/foo.py") == []
    up = 'from repro_torch.serve import engine\n'
    assert _rules(api_lint.check_source(
        up, "src/repro_torch/kernels/foo.py")) == {"layering"}


def test_thread_lint_and_pragma():
    src = ('import threading\n'
           'class W:\n'
           '    def start(self):\n'
           '        threading.Thread(target=self._loop).start()\n'
           '    def _loop(self):\n'
           '        self.n = 1\n')
    found = thread_lint.check_source(src, "src/repro_torch/x.py")
    assert _rules(found) == {"thread-unguarded"}
    quiet = src.replace("self.n = 1",
                        "self.n = 1  # check: ignore[thread-unguarded]")
    assert check.apply_pragmas(
        thread_lint.check_source(quiet, "src/repro_torch/x.py"), quiet) == []


# ----------------------------------------------------------- end to end
def test_smoke_catches_every_planted_rule(capsys):
    assert smoke.run() == 0
    assert "12 planted violations (12 rules) all caught" in \
        capsys.readouterr().out


_GATE = """
import sys
from repro_torch.check.__main__ import main
rc = main(["--root", sys.argv[1]])
assert "torch" not in sys.modules and "jax" not in sys.modules
raise SystemExit(rc)
"""


@pytest.mark.parametrize("args", [[], ["docs"]], ids=["all", "docs"])
def test_port_tree_lints_clean_without_torch(args):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    if args:
        out = subprocess.run([sys.executable, "-m", "repro_torch.check",
                              *args, "--root", str(REPO)], env=env,
                             capture_output=True, text=True, timeout=300)
    else:
        out = subprocess.run([sys.executable, "-c", _GATE, str(REPO)],
                             env=env, capture_output=True, text=True,
                             timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "ok" in out.stdout
