"""The benchmark's own count of the forwards' work."""
import json

import pytest

from bench import count
from bench.spec import HERE

D, FF, T = 1024, 4096, 384


def config(name):
    with open(HERE / "configs" / f"{name}.json") as f:
        return json.load(f)


def test_flops_a_request():
    """24 layers of QKV, attn-out, FFN up and down over 384 tokens."""
    per_token = 2 * 24 * (D * 3 * D + D * D + D * FF + FF * D)
    assert count.flops_per_request(config("bert_large")) == T * per_token
    assert T * per_token / 1e9 == pytest.approx(231.928, abs=5e-4)


def test_adapter_layer_by_hand():
    """attn-out declares C 1024 and qkv supplies 3072: it contracts over
    1024 and reads the 384 x 1024 it takes, and adds the stream (the
    previous ffn-dn's output) in layer 1, none in layer 0."""
    w = {x.name: x for x in count.layer_work(config("bert_large"))}
    assert w["bertl1-attn-out"].flops == 2 * T * D * D
    assert w["bertl1-attn-out"].act_bytes == 4 * (T * D + T * D + T * D)
    assert w["bertl0-attn-out"].act_bytes == 4 * (T * D + T * D)
    assert w["bertl1-attn-out"].weight_bytes == 4 * D * D


def test_residual_bytes_by_hand():
    """ffn-dn reads ffn-up's 384 x 4096, writes 384 x 1024 and adds
    attn-out's 384 x 1024."""
    w = {x.name: x for x in count.layer_work(config("bert_large"))}[
        "bertl5-ffn-dn"]
    assert w.act_bytes == 4 * (T * FF + T * D + T * D)
    assert w.weight_bytes == 4 * FF * D


def test_depthwise_layer_by_hand():
    """A 5x5 depthwise layer, stride 2, over 72 channels from a 28x28x72
    producer: each output 25 multiply-adds (not the 72-wide dense
    product); the producer read whole (zero padding is not read)."""
    cfg = {"input": [59, 59, 72], "skip_edges": [], "layers": [
        {"name": "pw", "M": 72, "C": 72, "P": 28, "Q": 28, "R": 1, "S": 1,
         "stride": 1},
        {"name": "dw", "M": 72, "C": 1, "P": 28, "Q": 28, "R": 5, "S": 5,
         "stride": 2}]}
    w = count.layer_work(cfg)[1]
    assert w.flops == 2 * 28 * 28 * 72 * 25
    assert w.act_bytes == 4 * (28 * 28 * 72 + 28 * 28 * 72)
    assert w.weight_bytes == 4 * 25 * 72


def test_least_time_is_the_larger_bound():
    pk = count.peaks()
    for w in count.layer_work(config("bert_large")):
        assert w.least_s(64, pk) == max(
            w.flops / pk["flops_per_s"],
            (w.act_bytes + w.weight_bytes / 64) / pk["bytes_per_s"])
