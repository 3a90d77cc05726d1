"""The benchmark's files: every cell resolves by name, BENCHMARK.json keeps
the contract's shape, and a configuration, a traffic mix and a per-layer
metric added as new files and entries are found with no file edited."""

import json
import re
import shutil
from pathlib import Path

import pytest

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_resolves(cell):
    c = harness.Cell(ROOT, cell)
    assert hasattr(c.driver(), "setup")
    e2e = {m["name"] for m in c.end_to_end()}
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = c.per_layer()
    assert layer
    for m in layer:
        assert callable(c.reader(m["name"]).read)
    art = c.config["artifact"]
    assert (ROOT / art["json"]).is_file() and (ROOT / art["pt"]).is_file()


def test_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert all(NAME.match(n) for n in names)
    for k in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({x["name"] for x in BENCH[k]}) == len(BENCH[k])
    for c in BENCH["configs"]:
        assert c["file"].startswith("portbench/") and not c["reduced"]
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for w in m.get("workloads", []):
            assert w in e2e[m["moves"]].get("workloads", [w])
    pairs = {(w["config"], w["traffic"]) for w in BENCH["workloads"]}
    assert len(pairs) == len(BENCH["workloads"])


def test_added_files_are_found(tmp_path):
    """A new configuration, traffic mix and per-layer metric, as files and
    entries only, in a copy of the benchmark."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads(json.dumps(BENCH))
    cfg = json.loads((ROOT / "portbench/configs/clifford27.json").read_text())
    cfg["name"] = "clifford27_copy"
    (tmp_path / "portbench/configs/clifford27_copy.json").write_text(
        json.dumps(cfg))
    traffic = json.loads(
        (ROOT / "portbench/traffic/synth_d8_n32768.json").read_text())
    traffic["num_searches"] = 1024
    (tmp_path / "portbench/traffic/synth_d8_n1024.json").write_text(
        json.dumps(traffic))
    (tmp_path / "portbench/metrics/calls.synth.py").write_text(
        "def read(run):\n    return run.calls\n")
    bench["configs"].append(dict(bench["configs"][0], name="clifford27_copy",
                                 file="portbench/configs/"
                                      "clifford27_copy.json"))
    bench["workloads"].append({"name": "copy.narrow",
                               "config": "clifford27_copy",
                               "traffic": "synth_d8_n1024", "chips": 1,
                               "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"] == "synth_per_s":
            m["workloads"].append("copy.narrow")
    bench["per_layer"].append({"name": "calls.synth", "unit": "calls",
                               "better": "higher", "source": "host_clock",
                               "layer": "front end", "moves": "synth_per_s",
                               "workloads": ["copy.narrow"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = harness.Cell(tmp_path, "copy.narrow")
    assert cell.config["name"] == "clifford27_copy"
    assert cell.traffic["num_searches"] == 1024
    assert cell.driver().__file__.startswith(str(tmp_path))
    assert [m["name"] for m in cell.per_layer()] == ["calls.synth"]

    class Rec:
        calls = 7

    assert cell.reader("calls.synth").read(Rec) == 7
    assert {m["name"] for m in cell.end_to_end()} == {"synth_per_s",
                                                      "setup_s"}


def test_rate_over_whole_calls():
    calls = [(0.0, 0.4), (0.4, 0.9), (0.9, 1.6)]
    assert harness.whole_call_rate(calls, 0.0) == pytest.approx(3 / 1.6)
    assert harness.whole_call_rate(calls[:1], 0.0) == pytest.approx(2.5)


def test_kernel_names():
    kb = harness.kernel_base
    assert kb("_Z17fused_step_kernel7StepArgs") == "fused_step_kernel"
    assert kb("void metrics_kernel<false, 128>(int const*)") == (
        "metrics_kernel")
    assert kb("_Z22fused_step_wide_kernel7StepArgs") != "fused_step_kernel"
    assert kb("void qgt::fused_step_kernel<2, false, true>(qgt::StepArgs)"
              ) == "fused_step_kernel"
    assert kb("void at::native::(anonymous namespace)::distribution_"
              "elementwise_grid_stride_kernel<float, 4>(int)") == (
        "distribution_elementwise_grid_stride_kernel")
    assert kb("Memcpy DtoD (Device -> Device)") == "Memcpy"


def test_whole_name_import_check():
    names = ["qiskit_gym_tpu_x", "qiskit_gym_torch.ops", "jaxtyping",
             "flaxen", "jax.numpy", "flax", "qiskit_gym_tpu.rl", "jaxlib"]
    assert harness.forbidden_modules(names) == [
        "flax", "jax.numpy", "jaxlib", "qiskit_gym_tpu.rl"]
