"""``BENCHMARK.json`` is well formed and every name finds its file; no run
loads JAX or the JAX package."""
import subprocess
import sys
import types

from bench import cell, spec


def test_benchmark_json_is_well_formed():
    assert spec.problems(spec.load_spec()) == []


def test_every_cell_loads_by_name():
    s = spec.load_spec()
    for w in s["workloads"]:
        c = spec.find_cell(w["name"], s)
        assert c.config["name"] == w["config"]
        assert {m["name"] for m in c.end_to_end} >= {"setup_s"}
        for m in c.per_layer:
            assert callable(spec.reader(m["name"]))


def test_problems_finds_a_bad_name_and_an_unreported_move():
    s = spec.load_spec()
    s["workloads"].append(dict(s["workloads"][0], name="extra.cell"))
    cells = [w["name"] for w in s["workloads"]]
    s["end_to_end"].append({"name": "x_ms", "unit": "ms", "better": "lower",
                            "bound": 0.1, "source": "host_clock",
                            "workloads": cells[:1]})
    s["per_layer"] = [dict(s["per_layer"][0], name="bad name", moves="x_ms",
                           workloads=cells)]
    found = spec.problems(s)
    assert any("forbidden character" in p for p in found)
    assert any("cell extra.cell does not report x_ms" in p for p in found)
    assert any("pair repeated" in p for p in found)


def test_guard_compares_whole_top_level_names():
    sys.modules["repro.fake_for_test"] = types.ModuleType("x")
    try:
        bad = cell.forbidden_modules()
    finally:
        del sys.modules["repro.fake_for_test"]
    assert "repro.fake_for_test" in bad
    assert not any(m.split(".")[0] == "repro_torch" for m in bad)


def test_a_run_imports_nothing_of_jax():
    code = ("import sys; sys.path[:0] = ['perfbench', 'src']; "
            "import run; run._environment(); "
            "from bench import cell, context, faults, reference, spec, "
            "trace, train; import repro_torch.api, repro_torch.serve.engine; "
            "import control_train; "
            "[train.model_module(spec.find_cell(w['name']).config) "
            "for w in spec.load_spec()['workloads'] "
            "if spec.find_cell(w['name']).config.get('kind')]; "
            "print(cell.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_no_card_no_result():
    import pytest
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                          "bert_large.offline", "--seed", "1", "--seconds",
                          "1", "--trace", "0"], cwd=spec.ROOT,
                         capture_output=True, text=True)
    assert out.returncode == 3 and out.stdout == ""
