"""Thread-shared-state lint: writes from thread-target methods need locks.

For every class that spawns a thread on one of its own methods
(``threading.Thread(target=self._worker, ...)``), the target method — and
every same-class method it calls through ``self.`` — runs concurrently
with the main thread.  Any ``self.<attr> = ...`` rebind in that closure
must happen inside a ``with self.<something-lock>:`` block (any attribute
whose name contains ``lock``), or the (class, attribute) pair must be in
``ALLOWLIST`` below with a reason — making the concurrency contract
reviewable instead of tribal (rule ``thread-unguarded``).

Scope and honesty: this is a *rebind* checker.  Mutation through method
calls (``self._queue.put(...)``, ``self._event.set()``) is out of reach of
a static pass and is exactly what the thread-safe stdlib primitives are
for; the lint enforces the part that has bitten real code — bare attribute
swaps racing the main thread.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Set

from . import Finding

#: (class name, attribute) -> reason the unguarded write is acceptable.
#: Additions here are the reviewable escape hatch.
ALLOWLIST: Dict[tuple, str] = {}


def _is_thread_ctor(node: ast.Call) -> bool:
    f = node.func
    if isinstance(f, ast.Name) and f.id == "Thread":
        return True
    return isinstance(f, ast.Attribute) and f.attr == "Thread"


def _self_attr(node: ast.expr) -> str | None:
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


def _target_methods(cls: ast.ClassDef) -> Set[str]:
    """Methods passed as ``target=self.<m>`` to a Thread constructor."""
    out: Set[str] = set()
    for node in ast.walk(cls):
        if isinstance(node, ast.Call) and _is_thread_ctor(node):
            for kw in node.keywords:
                if kw.arg == "target":
                    attr = _self_attr(kw.value)
                    if attr:
                        out.add(attr)
    return out


def _self_calls(fn: ast.FunctionDef) -> Set[str]:
    """Same-class methods invoked as ``self.<m>(...)`` inside ``fn``."""
    out: Set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            attr = _self_attr(node.func)
            if attr:
                out.add(attr)
    return out


class _WriteScanner(ast.NodeVisitor):
    """Collect ``self.<attr>`` rebinds with their lock-guard nesting."""

    def __init__(self) -> None:
        self.guard_depth = 0
        self.writes: List[tuple] = []   # (attr, lineno, guarded)

    def visit_With(self, node: ast.With) -> None:
        guarded = any(
            (attr := _self_attr(item.context_expr)) and "lock" in attr.lower()
            for item in node.items)
        self.guard_depth += 1 if guarded else 0
        self.generic_visit(node)
        self.guard_depth -= 1 if guarded else 0

    def _record(self, target: ast.expr, lineno: int) -> None:
        if isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                self._record(elt, lineno)
            return
        attr = _self_attr(target)
        if attr:
            self.writes.append((attr, lineno, self.guard_depth > 0))

    def visit_Assign(self, node: ast.Assign) -> None:
        for t in node.targets:
            self._record(t, node.lineno)
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self._record(node.target, node.lineno)
        self.generic_visit(node)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        self._record(node.target, node.lineno)
        self.generic_visit(node)


def check_source(text: str, rel: str) -> List[Finding]:
    findings: List[Finding] = []
    try:
        tree = ast.parse(text)
    except SyntaxError:
        return findings            # registry lint already reports this
    for cls in ast.walk(tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        targets = _target_methods(cls)
        if not targets:
            continue
        methods = {n.name: n for n in cls.body
                   if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
        # transitive closure of target methods over same-class self-calls
        closure: Set[str] = set()
        frontier = [m for m in targets if m in methods]
        while frontier:
            m = frontier.pop()
            if m in closure:
                continue
            closure.add(m)
            frontier.extend(c for c in _self_calls(methods[m])
                            if c in methods and c not in closure)
        for m in sorted(closure):
            scan = _WriteScanner()
            scan.visit(methods[m])
            for attr, lineno, guarded in scan.writes:
                if guarded or (cls.name, attr) in ALLOWLIST:
                    continue
                findings.append(Finding(
                    rel, lineno, "thread-unguarded",
                    f"{cls.name}.{m} runs on a spawned thread but writes "
                    f"self.{attr} outside a `with self.<lock>:` block "
                    f"(guard it or allowlist ({cls.name!r}, {attr!r}) in "
                    f"repro_torch.check.thread_lint with a reason)"))
    return findings
