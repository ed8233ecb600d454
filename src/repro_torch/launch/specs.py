# check: ignore-file[api-boundary]  (operator dev tool: inspects internals by design)
"""Fake stand-ins for every model input (no device allocation).

The counterpart of ``repro.launch.specs``: where ``repro`` hands XLA
``ShapeDtypeStruct``s, the port makes fake tensors under the
``FakeTensorMode`` its dry-run traces in (``repro_torch.launch.dryrun``):
they carry shapes, types and a device and no storage.  Call
``input_specs`` inside that mode, so the stand-ins belong to it.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch._guards import detect_fake_mode

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeCell, shape_by_name
from repro_torch.models import build_model


def input_specs(arch: str, shape: str, smoke: bool = False,
                model=None, device: str = "cpu",
                cell: Optional[ShapeCell] = None) -> Dict[str, Any]:
    """Stand-ins for one (arch x shape) cell, on ``device``:

    train:   {"batch": {"tokens" (B, T+1) int32, ["frames"]}}
    prefill: {"tokens" (B, T) int32, ["frames"]}
    decode:  {"cache": the cache, "tokens": (B,) int32}

    The decode cache is ``model``'s (built here where none is given):
    on a mesh (``place_model``) this data rank's local cache of
    ``cache_shardings``.  ``cell`` overrides the named shape cell."""
    if detect_fake_mode() is None:
        raise RuntimeError("input_specs makes fake tensors: call it inside "
                           "a FakeTensorMode")
    cfg = get_config(arch, smoke)
    cell = cell or shape_by_name(shape)
    B, T = cell.global_batch, cell.seq_len
    i32 = torch.int32

    def frames():
        return torch.empty((B, cfg.enc_frames, cfg.d_model),
                           dtype=getattr(torch, cfg.dtype), device=device)

    if cell.kind == "train":
        batch = {"tokens": torch.empty((B, T + 1), dtype=i32, device=device)}
        if cfg.family == "encdec":
            batch["frames"] = frames()
        return {"batch": batch}
    if cell.kind == "prefill":
        out = {"tokens": torch.empty((B, T), dtype=i32, device=device)}
        if cfg.family == "encdec":
            out["frames"] = frames()
        return out
    model = model if model is not None else build_model(cfg, device=device)
    rows = B
    if model.mesh is not None:
        from repro_torch.distributed.sharding import data_size
        d = data_size(model.mesh)
        rows = B // d if B % d == 0 else B
    return {"cache": model.init_cache(rows, T),
            "tokens": torch.empty((B,), dtype=i32, device=device)}


__all__ = ["input_specs"]
