"""The benchmark's own count of a forward's work: FLOPs and bytes a request.

It follows what the served graph computes, not what a kernel executes:

* a layer whose declared fan-in exceeds what its producer supplies
  contracts over what it has (the adapter drops the missing channels);
* a depthwise layer does R*S multiply-adds an output, not the dense
  block-diagonal product the port runs it as;
* the bytes are each layer's input activation as far as the layer reads it
  (a subsampled producer counts at the subsampled size, zero padding is not
  read), its output and each residual it adds, once each, plus its weights
  once a batch;
* a layer's least time is the larger of its FLOPs at the card's peak rate
  and its bytes at its memory rate (``peaks.json``), and the forward's is
  the sum over its layers.

fp32 operands at 4 bytes.
"""
from __future__ import annotations

import dataclasses
import json
from typing import List

from .spec import HERE

BYTES = 4


def peaks() -> dict:
    with open(HERE / "peaks.json") as f:
        return json.load(f)


def is_depthwise(layer: dict) -> bool:
    return layer["C"] == 1 and layer["M"] > 1 and \
        (layer["R"] > 1 or layer["S"] > 1)


def in_extent(layer: dict, axis: str) -> int:
    """The layer's input height (``"P"``) or width (``"Q"``), its SAME
    padding included."""
    k = layer["R"] if axis == "P" else layer["S"]
    return (layer[axis] - 1) * layer["stride"] + k


@dataclasses.dataclass(frozen=True)
class LayerWork:
    name: str
    flops: float            # a request
    act_bytes: float        # input read, output, residuals: a request
    weight_bytes: float     # once a batch

    def bytes_per_request(self, batch: int) -> float:
        return self.act_bytes + self.weight_bytes / batch

    def least_s(self, batch: int, pk: dict) -> float:
        return max(self.flops / pk["flops_per_s"],
                   self.bytes_per_request(batch) / pk["bytes_per_s"])


def layer_work(config: dict) -> List[LayerWork]:
    layers = config["layers"]
    shape = config["input"]
    out: List[LayerWork] = []
    for i, L in enumerate(layers):
        dw = is_depthwise(L)
        H, W = in_extent(L, "P"), in_extent(L, "Q")
        if i == 0:
            # the served input, zero-padded to H x W, read whole
            c_eff = min(L["M"] if dw else L["C"], shape[2])
            read = H * W * shape[2]
        else:
            prev = layers[i - 1]
            c_eff = min(L["M"] if dw else L["C"], prev["M"])
            # a larger axis is subsampled to the layer's, a smaller one read
            # whole and zero-padded: min(have, want) elements either way
            read = min(prev["P"], H) * min(prev["Q"], W) * c_eff
        outputs = L["P"] * L["Q"] * L["M"]
        res = 0
        for s, d in config["skip_edges"]:
            if d == i:
                src = layers[s]
                res += (min(src["P"], L["P"]) * min(src["Q"], L["Q"])
                        * min(src["M"], L["M"]))
        taps = L["R"] * L["S"]
        macs = outputs * taps * (1 if dw else c_eff)
        weights = taps * L["M"] * (1 if dw else c_eff)
        out.append(LayerWork(name=L["name"], flops=2.0 * macs,
                             act_bytes=float(BYTES * (read + outputs + res)),
                             weight_bytes=float(BYTES * weights)))
    return out


def flops_per_request(config: dict) -> float:
    return sum(w.flops for w in layer_work(config))


def least_s_per_request(config: dict, batch: int) -> float:
    """The forward's least time a request at ``batch`` requests a batch."""
    pk = peaks()
    return sum(w.least_s(batch, pk) for w in layer_work(config))
