"""CLI for ``repro_torch.check`` — see the package docstring for the contract.

    python -m repro_torch.check [--root DIR] [--format text|json]
    python -m repro_torch.check plan <artifact-or-dir>... [--format text|json]
    python -m repro_torch.check docs [--write]
    python -m repro_torch.check smoke

The bare invocation is the port's gate: registry + api-boundary + thread
lints over ``src/repro_torch``, ``chip_smoke.py`` and
``tools/kernel_bench.py``, doc-drift
against the registries, and the plan linter over ``tests/goldens`` when
present.  Exit status is the number of findings, clamped to 1.
"""
from __future__ import annotations

import argparse
import pathlib
import sys
from typing import List, Optional

from . import Finding, apply_pragmas, format_findings, python_sources
from . import api_lint, docs_gen, plan_lint, registry_lint, thread_lint

#: dirs the source checkers sweep (relative to --root)
SOURCE_DIRS = ("src/repro_torch", "chip_smoke.py", "tools/kernel_bench.py")
#: the obs package defines the emission functions; exempt from the
#: obs-name registry lint (it would flag the definitions' own doctests)
_REGISTRY_EXEMPT = "src/repro_torch/obs/"


def run_source_checks(root: pathlib.Path) -> List[Finding]:
    findings: List[Finding] = []
    for path in python_sources(root, SOURCE_DIRS):
        rel = str(path.relative_to(root)).replace("\\", "/")
        text = path.read_text()
        per_file: List[Finding] = []
        if not rel.startswith(_REGISTRY_EXEMPT):
            per_file.extend(registry_lint.check_source(text, rel))
        per_file.extend(api_lint.check_source(text, rel))
        per_file.extend(thread_lint.check_source(text, rel))
        findings.extend(apply_pragmas(per_file, text))
    return findings


def run_default(root: pathlib.Path) -> List[Finding]:
    findings = run_source_checks(root)
    findings.extend(docs_gen.check_docs(root))
    goldens = root / "tests" / "goldens"
    if goldens.is_dir():
        findings.extend(plan_lint.check_paths([goldens], root))
    return findings


def _emit(findings: List[Finding], fmt: str, label: str) -> int:
    if findings:
        print(format_findings(findings, fmt))
        if fmt == "text":
            print(f"repro_torch.check: {len(findings)} finding(s) "
                  f"[{label}]",
                  file=sys.stderr)
        return 1
    if fmt == "text":
        print(f"repro_torch.check: ok [{label}]")
    else:
        print("[]")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    cmd = argv.pop(0) if argv and argv[0] in ("plan", "docs",
                                              "smoke", "source") else None

    ap = argparse.ArgumentParser(prog="python -m repro_torch.check")
    ap.add_argument("--root", default=".", help="repo root to check")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    if cmd == "plan":
        ap.add_argument("paths", nargs="+",
                        help="plan artifact files and/or directories")
    if cmd == "docs":
        ap.add_argument("--write", action="store_true",
                        help="regenerate the docstring blocks in place")
    args = ap.parse_args(argv)
    root = pathlib.Path(args.root).resolve()

    if cmd == "smoke":
        from . import smoke
        return smoke.run()
    if cmd == "docs":
        if args.write:
            changed = docs_gen.write_docs(root)
            print("rewrote: " + ", ".join(changed) if changed
                  else "generated docs already current")
            return 0
        return _emit(docs_gen.check_docs(root), args.format, "docs")
    if cmd == "plan":
        return _emit(plan_lint.check_paths(args.paths, root),
                     args.format, "plan artifacts")
    if cmd == "source":
        return _emit(run_source_checks(root), args.format, "source")
    return _emit(run_default(root), args.format,
                 "source+docs+goldens")


if __name__ == "__main__":
    raise SystemExit(main())
