"""repro_torch.check — static contract verification for the PyTorch port.

The copy of ``repro.check`` for ``repro_torch``, changed only where it
names the package: the same twelve rules over the port's sources, its
registries and the plan goldens (which both packages write byte for
byte).

The stack coordinates its subsystems through stringly-typed contracts:
fault-site names (``faults.site("plan.load")``), obs metric/span families
(``plan_cache.hit{tier=}``), the plan artifact schema (v1–v4), the
``repro_torch.api`` facade boundary, and lock-guarded engine state.  None of
those is caught by the type checker — a typo'd site never injects, a
typo'd counter silently forks a new series, a hand-edited plan artifact
only fails at execution time.  This package machine-checks all of them:

``python -m repro_torch.check``
    the source checkers (registry / api-boundary / thread lints, doc
    drift) plus the plan linter over ``tests/goldens`` — the CI gate.
``python -m repro_torch.check plan <artifact-or-dir>...``
    the plan artifact linter over explicit paths (chaos-sweep output).
``python -m repro_torch.check docs [--write]``
    verify (or regenerate) the docstring inventories that are generated
    from the ``repro_torch.obs.names`` / ``runtime.faults`` registries.
``python -m repro_torch.check smoke``
    self-test: plant one violation per rule in fixture sources/artifacts
    and assert every one is caught.

All checkers emit one ``Finding`` shape (file, line, rule id, message),
rendered as text or ``--format json``.  Stdlib-only on purpose: it runs
with no torch installed.

Suppressing a finding
---------------------
Append ``# check: ignore[rule-id]`` to the flagged line, or put
``# check: ignore-file[rule-id]`` anywhere in a file that is deliberately
exempt (e.g. a paper-figure benchmark that must reach core internals).
Several rules: ``ignore[rule-a,rule-b]``.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import re
from typing import Dict, Iterable, List, Sequence

#: rule id -> what it enforces (the README table is kept in sync by hand;
#: ``smoke`` plants one violation per id, so an id without a working
#: checker fails CI)
RULES: Dict[str, str] = {
    "site-unknown":
        "faults.site(...)/retry site= literal not in the SITES registry",
    "obs-unknown":
        "obs counter/gauge/histogram/span name not in repro_torch.obs.names",
    "obs-label":
        "obs emission label keys differ from the registered label set",
    "docs-drift":
        "generated docstring inventory is stale (run `check docs --write`)",
    "api-boundary":
        "launch imports repro_torch internals, not repro_torch.api",
    "layering":
        "repro_torch.core/kernels import upward (plan/serve/launch/api)",
    "thread-unguarded":
        "thread-target method writes shared attribute outside a lock",
    "plan-version":
        "plan artifact fields inconsistent with its declared version",
    "plan-fused-chain":
        "fused_with does not chain to the next step / chain ends fused",
    "plan-boundary":
        "adjacent steps disagree on the boundary layout between them",
    "plan-join":
        "join references a non-earlier step or the wrong source layout",
    "plan-buffer-alloc":
        "buffer_alloc illegal for the step's tiling/double_buffer mode",
}


@dataclasses.dataclass(frozen=True)
class Finding:
    """One violation: where, which rule, and what went wrong."""

    file: str          # path relative to the checked root
    line: int          # 1-indexed; 1 for whole-artifact findings
    rule: str          # key into RULES
    message: str

    def format(self) -> str:
        return f"{self.file}:{self.line}: [{self.rule}] {self.message}"

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)


_IGNORE_RE = re.compile(r"#\s*check:\s*ignore\[([a-z\-, ]+)\]")
_IGNORE_FILE_RE = re.compile(r"#\s*check:\s*ignore-file\[([a-z\-, ]+)\]")


def _rules_in(match: re.Match) -> frozenset:
    return frozenset(r.strip() for r in match.group(1).split(","))


def apply_pragmas(findings: Sequence[Finding], text: str) -> List[Finding]:
    """Drop findings suppressed by ``# check: ignore[...]`` pragmas in the
    source ``text`` all of them point into."""
    file_ignored: frozenset = frozenset()
    for m in _IGNORE_FILE_RE.finditer(text):
        file_ignored = file_ignored | _rules_in(m)
    lines = text.split("\n")
    out = []
    for f in findings:
        if f.rule in file_ignored:
            continue
        line = lines[f.line - 1] if 0 < f.line <= len(lines) else ""
        m = _IGNORE_RE.search(line)
        if m and f.rule in _rules_in(m):
            continue
        out.append(f)
    return out


def python_sources(root: pathlib.Path,
                   rel_dirs: Iterable[str]) -> List[pathlib.Path]:
    """Every ``.py`` file under ``root/<d>`` for the dirs that exist."""
    out: List[pathlib.Path] = []
    for d in rel_dirs:
        base = root / d
        if base.is_dir():
            out.extend(sorted(base.rglob("*.py")))
        elif base.is_file():
            out.append(base)
    return out


def format_findings(findings: Sequence[Finding], fmt: str = "text") -> str:
    if fmt == "json":
        return json.dumps([f.to_dict() for f in findings], indent=2)
    return "\n".join(f.format() for f in findings)
