"""Plan artifact linter: semantic invariants the JSON schema can't express.

Operates on the raw artifact dict (never through ``ExecutionPlan.from_json``)
so it stays stdlib-only and can flag exactly the field that is wrong —
including artifacts the loader would happily accept.  The invariants:

``plan-version``
    ``version`` must be one of ``COMPAT_VERSIONS``, and no step may carry
    a field newer than the declared version (a v2 artifact with
    ``buffer_alloc`` is drift, not forward compatibility).
``plan-fused-chain``
    ``fused_with`` must point at the *next* step (``i + 1``) and stay in
    range, so fusion forms contiguous chains whose last step is unfused.
``plan-boundary``
    ``steps[i].in_layout`` must equal ``steps[i-1].out_layout`` — one
    boundary layout per graph edge, the DP-path invariant
    ``ExecutionPlan.boundary_layouts`` assumes.
``plan-join``
    every join must reference a strictly earlier step, and its
    ``src_layout`` must be the layout that step actually wrote.
``plan-buffer-alloc``
    ``buffer_alloc`` entries come from ``BUFFER_TENSORS``, without
    duplicates; the all-three subset must be normalized to
    ``double_buffer`` (which in turn requires an empty ``buffer_alloc``),
    and per-tensor ping-pong needs a tiling to ping-pong over.

``COMPAT_VERSIONS`` / ``BUFFER_TENSORS`` are mirrored here (not imported)
so the linter never drags in torch; ``tests/test_torch_check.py`` asserts
the mirrors equal the canonical values in ``repro_torch.plan`` /
``repro_torch.core``.
"""
from __future__ import annotations

import json
import pathlib
from typing import Dict, List, Sequence

from . import Finding

# mirrors of repro_torch.plan.COMPAT_VERSIONS /
# repro_torch.core.dataflow.BUFFER_TENSORS (drift-tested in
# tests/test_torch_check.py)
COMPAT_VERSIONS = (1, 2, 3, 4)
BUFFER_TENSORS = ("iact", "w", "oact")

# step-level field -> first schema version that may carry it
_FIELD_MIN_VERSION = {
    "tiles": 2,
    "double_buffer": 3,
    "buffer_alloc": 4,
    "fused_with": 4,
    "dram_stall_cycles": 4,
}


def looks_like_plan(doc: object) -> bool:
    """Sniff for plan artifacts when linting a directory of mixed JSON."""
    return isinstance(doc, dict) and "steps" in doc and "graph_hash" in doc


def check_plan(doc: Dict, rel: str) -> List[Finding]:
    """All findings for one parsed plan artifact."""
    findings: List[Finding] = []

    def bad(rule: str, msg: str) -> None:
        findings.append(Finding(rel, 1, rule, msg))

    version = doc.get("version")
    if version not in COMPAT_VERSIONS:
        bad("plan-version",
            f"declared version {version!r} not in {COMPAT_VERSIONS}")
        version = max(COMPAT_VERSIONS)    # still run the structural checks
    steps = doc.get("steps")
    if not isinstance(steps, list):
        bad("plan-version", "artifact has no 'steps' list")
        return findings

    n = len(steps)
    for i, s in enumerate(steps):
        if not isinstance(s, dict):
            bad("plan-version", f"step {i} is not an object")
            continue

        # ---- declared version vs fields actually present ----------------
        for field, minv in _FIELD_MIN_VERSION.items():
            if field in s and version < minv:
                bad("plan-version",
                    f"step {i} carries v{minv} field {field!r} but the "
                    f"artifact declares version {version}")

        # ---- fusion chain ------------------------------------------------
        fused = s.get("fused_with")
        if fused is not None:
            if fused != i + 1:
                bad("plan-fused-chain",
                    f"step {i} fused_with={fused}; fusion must chain to "
                    f"the next step ({i + 1})")
            elif fused >= n:
                bad("plan-fused-chain",
                    f"step {i} (the last step) is fused past the end of "
                    f"the plan")

        # ---- boundary layout continuity -----------------------------------
        if i > 0 and isinstance(steps[i - 1], dict):
            prev_out = steps[i - 1].get("out_layout")
            if s.get("in_layout") != prev_out:
                bad("plan-boundary",
                    f"step {i} reads {s.get('in_layout')!r} but step "
                    f"{i - 1} wrote {prev_out!r}")

        # ---- joins --------------------------------------------------------
        for j, join in enumerate(s.get("joins", ())):
            src = join.get("src")
            if not isinstance(src, int) or not 0 <= src < i:
                bad("plan-join",
                    f"step {i} join {j} src={src!r} must reference a "
                    f"strictly earlier step")
                continue
            src_step = steps[src]
            if (isinstance(src_step, dict)
                    and join.get("src_layout") != src_step.get("out_layout")):
                bad("plan-join",
                    f"step {i} join {j} src_layout="
                    f"{join.get('src_layout')!r} but step {src} wrote "
                    f"{src_step.get('out_layout')!r}")

        # ---- buffer allocation -------------------------------------------
        alloc = s.get("buffer_alloc", [])
        unknown = [t for t in alloc if t not in BUFFER_TENSORS]
        if unknown:
            bad("plan-buffer-alloc",
                f"step {i} buffer_alloc has unknown tensor(s) {unknown}; "
                f"legal: {list(BUFFER_TENSORS)}")
        elif len(set(alloc)) != len(alloc):
            bad("plan-buffer-alloc",
                f"step {i} buffer_alloc {alloc} has duplicates")
        elif len(alloc) == len(BUFFER_TENSORS):
            bad("plan-buffer-alloc",
                f"step {i} ping-pongs all of {list(BUFFER_TENSORS)}; that "
                f"must be normalized to double_buffer=true with an empty "
                f"buffer_alloc")
        if alloc and s.get("double_buffer"):
            bad("plan-buffer-alloc",
                f"step {i} sets double_buffer with a non-empty "
                f"buffer_alloc {alloc}; the modes are exclusive")
        tiles = s.get("tiles") or (s.get("dataflow") or {}).get("tiles")
        if alloc and not unknown and not tiles:
            bad("plan-buffer-alloc",
                f"step {i} ping-pongs {alloc} but plans no tiling — "
                f"there is no tile stream to double-buffer")

    return findings


def check_paths(paths: Sequence[str | pathlib.Path],
                root: pathlib.Path) -> List[Finding]:
    """Lint explicit artifact files and/or directories of ``*.json``.

    Files passed explicitly must be plan artifacts; in directories, JSON
    documents that don't look like plans (no ``steps``/``graph_hash``) are
    skipped, so a goldens dir can hold other fixtures too.
    """
    findings: List[Finding] = []
    for p in paths:
        p = pathlib.Path(p)
        files = sorted(p.rglob("*.json")) if p.is_dir() else [p]
        for f in files:
            try:
                rel = str(f.relative_to(root))
            except ValueError:
                rel = str(f)
            try:
                doc = json.loads(f.read_text())
            except (OSError, json.JSONDecodeError) as e:
                findings.append(Finding(rel, 1, "plan-version",
                                        f"unreadable artifact: {e}"))
                continue
            if p.is_dir() and not looks_like_plan(doc):
                continue
            findings.extend(check_plan(doc, rel))
    return findings
