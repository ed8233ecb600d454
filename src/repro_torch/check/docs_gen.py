"""Generated-docstring check/writer: registries are the source of truth.

The obs metric inventory in ``src/repro_torch/obs/__init__.py`` and the
fault-site table in ``src/repro_torch/runtime/faults.py`` are rendered from
the ``repro_torch.obs.names`` / ``repro_torch.runtime.faults`` registries
between marker lines::

    -- generated by `python -m repro_torch.check docs --write`; do not edit --
    ...rendered block...
    -- end generated --

``check_docs`` reports ``docs-drift`` when the text between the markers
differs from what the registry renders today (or the markers are missing);
``write_docs`` rewrites the block in place.  Editing the prose around the
markers stays free; editing the inventory means editing the registry.
"""
from __future__ import annotations

import pathlib
from typing import Callable, List, Tuple

from . import Finding

BEGIN = ("-- generated by `python -m repro_torch.check docs --write`; "
         "do not edit --")
END = "-- end generated --"


def _targets() -> List[Tuple[str, Callable[[], str]]]:
    # late imports: keep `import repro_torch.check` itself dependency-free
    from repro_torch.obs import names as obs_names
    from repro_torch.runtime import faults

    return [
        ("src/repro_torch/obs/__init__.py", obs_names.render_inventory),
        ("src/repro_torch/runtime/faults.py", faults.render_site_table),
    ]


def _split(text: str, rel: str) -> Tuple[str, str, str] | Finding:
    """(before, block, after) around the markers, or a finding."""
    if BEGIN not in text or END not in text:
        return Finding(rel, 1, "docs-drift",
                       f"missing generated-block markers ({BEGIN!r})")
    head, rest = text.split(BEGIN, 1)
    block, tail = rest.split(END, 1)
    return head, block, tail


def check_docs(root: pathlib.Path) -> List[Finding]:
    findings: List[Finding] = []
    for rel, render in _targets():
        path = root / rel
        if not path.is_file():
            findings.append(Finding(rel, 1, "docs-drift",
                                    "generated-doc target file is missing"))
            continue
        text = path.read_text()
        parts = _split(text, rel)
        if isinstance(parts, Finding):
            findings.append(parts)
            continue
        _, block, _ = parts
        if block.strip("\n") != render():
            line = text[:text.index(BEGIN)].count("\n") + 1
            findings.append(Finding(
                rel, line, "docs-drift",
                "generated inventory is stale vs the registry; run "
                "`python -m repro_torch.check docs --write`"))
    return findings


def write_docs(root: pathlib.Path) -> List[str]:
    """Regenerate every target block in place; returns files rewritten."""
    changed: List[str] = []
    for rel, render in _targets():
        path = root / rel
        text = path.read_text()
        parts = _split(text, rel)
        if isinstance(parts, Finding):
            raise SystemExit(f"{rel}: {parts.message}")
        head, block, tail = parts
        new_block = "\n" + render() + "\n"
        if block != new_block:
            path.write_text(head + BEGIN + new_block + END + tail)
            changed.append(rel)
    return changed
