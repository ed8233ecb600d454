"""Registry lints: fault-site names and obs metric/span families.

Walks the AST of every source file and checks

* ``faults.site(<literal>)`` and ``retry_call(..., site=<literal>)`` /
  ``self._retry(..., site=<literal>)`` against the ``SITES`` /
  ``RETRY_SITES`` registries in ``repro_torch.runtime.faults`` (rule
  ``site-unknown``).  ``faults.<CONST>`` attribute arguments are resolved
  against the module's exported constants, so
  ``faults.site(faults.PLAN_LOAD)`` is checked too.
* ``obs.inc_counter`` / ``obs.set_gauge`` / ``obs.observe`` /
  ``obs.span`` / ``obs.record_span`` emissions against
  ``repro_torch.obs.names`` — unknown or wrong-kind names are ``obs-unknown``;
  for metrics, the keyword label-key set must exactly match the
  registered keys (``obs-label``), so ``tiers="mem"`` for the registered
  ``tier`` key is an error, as is dropping a registered key.  Calls that
  expand ``**labels`` dynamically are skipped (not statically checkable);
  spans are checked for name membership only, their attrs are open-ended.

Only the ``obs.<fn>`` / ``faults.site`` attribute idioms are matched — the
repo-wide convention — so a local helper that happens to be called
``observe`` is not misflagged.  ``src/repro_torch/obs/`` itself is exempt (it
defines the emission functions).
"""
from __future__ import annotations

import ast
from typing import List, Optional

from repro_torch.obs import names as obs_names
from repro_torch.runtime import faults as faults_mod

from . import Finding

# obs emission function -> metric kind ("span" families have no label check)
_OBS_FUNCS = {
    "inc_counter": "counter",
    "set_gauge": "gauge",
    "observe": "histogram",
    "span": "span",
    "record_span": "span",
}
# keyword args that are operands, not labels
_NON_LABEL_KW = {"inc_counter": {"n"}, "set_gauge": set(), "observe": set()}

_RETRY_FUNCS = {"retry_call", "_retry"}


def _attr_chain_tail(node: ast.expr) -> Optional[str]:
    """``faults.site`` -> ``site`` when the object is (or ends in) the
    expected module name; None when the call shape doesn't match."""
    if isinstance(node, ast.Attribute):
        return node.attr
    return None


def _receiver_name(node: ast.expr) -> Optional[str]:
    """The name the method is called on: ``obs`` for ``obs.span``,
    ``faults`` for ``x.y.faults.site``, ``self`` for ``self._retry``."""
    if not isinstance(node, ast.Attribute):
        return None
    v = node.value
    if isinstance(v, ast.Name):
        return v.id
    if isinstance(v, ast.Attribute):
        return v.attr
    return None


def _literal_site(node: ast.expr) -> Optional[str]:
    """String literal, or a ``faults.<CONST>`` reference resolved against
    the real module; None when the argument is dynamic."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    if isinstance(node, ast.Attribute) and _receiver_name(node) is None:
        return None
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "faults"):
        val = getattr(faults_mod, node.attr, None)
        if isinstance(val, str):
            return val
        return f"<faults.{node.attr}: unresolved>"
    return None


def _check_site_call(call: ast.Call, rel: str,
                     findings: List[Finding]) -> None:
    if not call.args:
        return
    name = _literal_site(call.args[0])
    if name is None:
        return
    if name not in faults_mod.SITES:
        findings.append(Finding(
            rel, call.lineno, "site-unknown",
            f"fault site {name!r} is not in faults.SITES "
            f"(registered: {sorted(faults_mod.SITES)})"))


def _check_retry_call(call: ast.Call, rel: str,
                      findings: List[Finding]) -> None:
    for kw in call.keywords:
        if kw.arg != "site":
            continue
        name = _literal_site(kw.value)
        if name is None:
            continue
        if name not in faults_mod.RETRY_SITES:
            findings.append(Finding(
                rel, call.lineno, "site-unknown",
                f"retry site {name!r} is not in faults.RETRY_SITES "
                f"(registered: {sorted(faults_mod.RETRY_SITES)})"))


def _check_obs_call(call: ast.Call, fn: str, rel: str,
                    findings: List[Finding]) -> None:
    if not call.args:
        return
    arg0 = call.args[0]
    if not (isinstance(arg0, ast.Constant) and isinstance(arg0.value, str)):
        return
    name = arg0.value
    kind = _OBS_FUNCS[fn]
    if kind == "span":
        if name not in obs_names.SPANS:
            where = _kind_of(name)
            findings.append(Finding(
                rel, call.lineno, "obs-unknown",
                f"span {name!r} is not in repro_torch.obs.names.SPANS"
                + (f" (registered as a {where})" if where else "")))
        return
    registry = obs_names.METRICS[kind]
    if name not in registry:
        where = _kind_of(name)
        findings.append(Finding(
            rel, call.lineno, "obs-unknown",
            f"{kind} {name!r} is not registered in repro_torch.obs.names"
            + (f" (registered as a {where})" if where else "")))
        return
    if any(kw.arg is None for kw in call.keywords):
        return                     # **labels expansion: not checkable
    got = {kw.arg for kw in call.keywords} - _NON_LABEL_KW[fn]
    want = set(registry[name][0])
    if got != want:
        findings.append(Finding(
            rel, call.lineno, "obs-label",
            f"{kind} {name!r} emitted with label keys {sorted(got)}, "
            f"registry says {sorted(want)}"))


def _kind_of(name: str) -> Optional[str]:
    for kind, reg in obs_names.METRICS.items():
        if name in reg:
            return kind
    if name in obs_names.SPANS:
        return "span"
    return None


def check_source(text: str, rel: str) -> List[Finding]:
    """All registry findings for one file's source text."""
    findings: List[Finding] = []
    try:
        tree = ast.parse(text)
    except SyntaxError as e:
        return [Finding(rel, e.lineno or 1, "site-unknown",
                        f"unparseable source: {e.msg}")]
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        fn = _attr_chain_tail(node.func)
        recv = _receiver_name(node.func)
        if fn == "site" and recv == "faults":
            _check_site_call(node, rel, findings)
        elif fn in _RETRY_FUNCS or (
                isinstance(node.func, ast.Name)
                and node.func.id in _RETRY_FUNCS):
            _check_retry_call(node, rel, findings)
        elif fn in _OBS_FUNCS and recv == "obs":
            _check_obs_call(node, fn, rel, findings)
    return findings
