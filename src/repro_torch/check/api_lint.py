"""Import-graph lints: the API facade boundary and core layering.

``api-boundary``
    Application code — the port's ``src/repro_torch/launch`` — may import
    only the stable facade ``repro_torch.api`` plus ``repro_torch.obs``
    (the zero-dependency observability surface; routing it through the
    torch-heavy facade would defeat its import-light contract).  Dev tools
    that deliberately reach internals opt out with a
    ``# check: ignore-file[api-boundary]`` pragma, which keeps the
    exemption reviewable in the diff.
``layering``
    The bottom of the stack — ``repro_torch.core`` and
    ``repro_torch.kernels`` — may not import upward into
    ``repro_torch.plan`` / ``repro_torch.serve`` / ``repro_torch.launch`` /
    ``repro_torch.api`` / ``repro_torch.check``: cost models and
    kernels must stay usable without the orchestration layers.

Both rules walk every ``import`` statement (module level or nested) and
resolve relative imports against the file's package, so ``from ..plan
import X`` inside ``core/`` is caught just like the absolute form.
"""
from __future__ import annotations

import ast
import pathlib
from typing import Iterator, List, Tuple

from . import Finding

#: dirs (relative to the repo root) that hold application code
APP_DIRS = ("src/repro_torch/launch",)
#: the only repro_torch modules application code may import
APP_ALLOWED = ("repro_torch.api", "repro_torch.obs")

#: the bottom layers and the modules they must not reach up into
LOW_DIRS = ("src/repro_torch/core", "src/repro_torch/kernels")
UPWARD = ("repro_torch.plan", "repro_torch.serve", "repro_torch.launch",
          "repro_torch.api", "repro_torch.check")
#: the package these rules govern
PACKAGE = "repro_torch"


def _package_of(rel: str) -> str:
    """Dotted package a source file lives in (``src/repro_torch/core/x.py``
    -> ``repro_torch.core``); '' for top-level scripts like
    ``chip_smoke.py``."""
    parts = pathlib.PurePosixPath(rel.replace("\\", "/")).parts
    if parts and parts[0] == "src":
        parts = parts[1:]
    return ".".join(parts[:-1])


def _imports(tree: ast.AST, package: str) -> Iterator[Tuple[str, int]]:
    """Every imported module as an absolute dotted name + line number."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name, node.lineno
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = package.split(".")
                base = base[:len(base) - (node.level - 1)]
                mod = ".".join(base + ([node.module] if node.module else []))
            else:
                mod = node.module or ""
            if not mod:
                continue
            yield mod, node.lineno
            # `from repro_torch import plan` imports repro_torch.plan
            if mod == PACKAGE:
                for alias in node.names:
                    yield f"{PACKAGE}.{alias.name}", node.lineno


def _is_under(mod: str, prefix: str) -> bool:
    return mod == prefix or mod.startswith(prefix + ".")


def check_source(text: str, rel: str) -> List[Finding]:
    findings: List[Finding] = []
    try:
        tree = ast.parse(text)
    except SyntaxError:
        return findings            # registry lint already reports this
    rel_posix = rel.replace("\\", "/")
    in_app = any(rel_posix.startswith(d + "/") for d in APP_DIRS)
    in_low = any(rel_posix.startswith(d + "/") for d in LOW_DIRS)
    if not (in_app or in_low):
        return findings
    package = _package_of(rel)
    for mod, lineno in _imports(tree, package):
        if not _is_under(mod, PACKAGE):
            continue
        if in_app and mod != PACKAGE \
                and not any(_is_under(mod, a) for a in APP_ALLOWED):
            findings.append(Finding(
                rel, lineno, "api-boundary",
                f"application code imports {mod!r}; only "
                f"{list(APP_ALLOWED)} are stable (or add a reviewed "
                f"`# check: ignore-file[api-boundary]` pragma)"))
        if in_low and any(_is_under(mod, u) for u in UPWARD):
            findings.append(Finding(
                rel, lineno, "layering",
                f"{package or rel} imports upward into {mod!r}; core/"
                f"kernels must not depend on the orchestration layers"))
    return findings
