"""The port's planner emits the JAX package's plans, byte for byte.

``repro_torch`` keeps copies of the numpy planner modules instead of
importing them, so these tests pin that the copies have not drifted: the
same graph and options give the same ``ExecutionPlan`` JSON in both
packages, and every checked-in plan artifact loads in the port and
re-serializes exactly as the JAX package re-serializes it.
"""
import pathlib

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core.layout import Layout as JLayout
from repro.core.layoutloop import EvalConfig as JEvalConfig
from repro.core.workloads import init_graph_weights as j_init
from repro.plan import ExecutionPlan as JPlan
from repro.plan import NetworkPlanner as JPlanner
from repro.plan import PlannerOptions as JOpts
from repro.plan import resnet50_graph as j_resnet50
from repro.plan import step_kernel_blocks as j_blocks
from repro.obs.smoke import build_graph as j_build_graph
from repro.serve.config import DEFAULT_LAYOUTS
from repro_torch.core.layout import Layout
from repro_torch.core.layoutloop import EvalConfig
from repro_torch.core.workloads import init_graph_weights
from repro_torch.plan import (ExecutionPlan, NetworkPlanner,
                              PlannerOptions, resnet50_graph,
                              step_kernel_blocks)
from repro_torch.serve import build_graph
from repro_torch.serve.config import DEFAULT_LAYOUTS as T_LAYOUTS

GOLDENS = pathlib.Path(__file__).parent / "goldens"
ARTIFACTS = ["plan_bert.json", "plan_mobilenet_v3.json",
             "plan_resnet50.json", "plan_v1_fixture.json",
             "plan_v2_fixture.json", "plan_v3_fixture.json"]


def _serve_opts(opts_cls, layout_cls, layouts):
    """The serve engine's planner options (``_planner_options``)."""
    return opts_cls(switch_modes=("rir",),
                    layouts=tuple(layout_cls.parse(s) for s in layouts),
                    parallel_dims=("C", "P", "Q"))


@pytest.fixture(scope="module")
def plans():
    """Each package's plan JSON for tiny and resnet50 at serve batch 8."""
    out = {}
    for name in ("tiny", "resnet50"):
        g = build_graph(name).with_batch(8)
        jg = j_build_graph(name).with_batch(8)
        out[name] = (
            NetworkPlanner(g, EvalConfig(), _serve_opts(
                PlannerOptions, Layout, T_LAYOUTS)).plan(),
            JPlanner(jg, JEvalConfig(), _serve_opts(
                JOpts, JLayout, DEFAULT_LAYOUTS)).plan())
    return out


@pytest.mark.parametrize("name", ["tiny", "resnet50"])
def test_plan_json_byte_identical(plans, name):
    mine, theirs = plans[name]
    assert mine.to_json() == theirs.to_json()
    assert mine.plan_id == theirs.plan_id


def test_kernel_blocks_agree(plans):
    mine, theirs = plans["resnet50"]
    assert [step_kernel_blocks(s) for s in mine.steps] == \
        [j_blocks(s) for s in theirs.steps]


@pytest.mark.parametrize("name", ARTIFACTS)
def test_checked_in_artifacts_roundtrip(name):
    text = (GOLDENS / name).read_text()
    mine = ExecutionPlan.from_json(text)
    theirs = JPlan.from_json(text)
    assert mine.version == theirs.version
    assert mine.to_json() == theirs.to_json()
    assert ExecutionPlan.from_json(mine.to_json()) == mine
    if "fixture" not in name:      # current-schema goldens: exact text
        assert mine.to_json() == text


def test_graphs_and_hashes_agree():
    g, jg = resnet50_graph(), j_resnet50()
    assert g.graph_hash() == jg.graph_hash()
    assert g.input_shape() == jg.input_shape()
    assert g.skip_edges == jg.skip_edges


@pytest.mark.parametrize("seed", [0, 3])
def test_init_graph_weights_identical(seed):
    layers = list(resnet50_graph().layers)
    mine = init_graph_weights(layers, seed=seed)
    theirs = j_init(list(j_resnet50().layers), seed=seed)
    assert len(mine) == len(theirs)
    for a, b in zip(mine, theirs):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
