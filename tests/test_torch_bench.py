"""The port's throughput bench (`qiskit_gym_torch/tools/bench.py`,
`bench_fused.py`) against the JAX package's `bench.py`, on the CPU.

- The bench's step program equals bench.py's scan body bit for bit on
  every state field, for all four 27q heavy-hex families at B = 64 and
  K = 8 (Pauli as bench.py configures it): the JAX reset state is carried
  across, the same actions and flips come from a numpy seed, and the port
  gets at each step the `perm_idx` that the JAX step drew.
- `bench_core` returns B * K / min(times) (a patched clock).
- The headline prints one JSON line with bench.py's keys (read from its
  source) plus `card`.
- `--mesh` on 2 gloo processes (the spawn harness of
  `test_torch_parallel.py`): positive rates, each process steps its own
  block of lanes, and the gathered final state equals the one-process
  final state under the same draws.
- The 127-qubit Clifford line through `bench_core` (the `--scale` core).
"""

import ast
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qiskit_gym_torch.envs import CliffordGym, PermutationGym
from qiskit_gym_torch.examples._common import HEAVY_HEX_27, REPO
from qiskit_gym_torch.ops.matrix_env import (MatrixEnvCore, MatrixEnvState,
                                             state_from_arrays)
from qiskit_gym_torch.ops.pauli import PauliEnvCore, PauliEnvState
from qiskit_gym_torch.tools import bench, bench_fused
from qiskit_gym_tpu import envs as jenvs
from test_torch_parallel import _spawn

B, K = 64, 8
MESH_B, MESH_K, MESH_SEED = 64, 4, 5


def bench_py_function(name: str):
    src = open(os.path.join(REPO, "bench.py")).read()
    return next(n for n in ast.parse(src).body
                if isinstance(n, ast.FunctionDef) and n.name == name)


def json_keys(name: str) -> set:
    """The keys of the dict that bench.py's `name` passes to json.dumps."""
    for node in ast.walk(bench_py_function(name)):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "dumps"):
            return {k.value for k in node.args[0].keys}
    raise AssertionError(f"no json.dumps in bench.py's {name}")


def family_names(name: str) -> set:
    """The families that bench.py's `name` writes into `results`."""
    return {node.targets[0].slice.value
            for node in ast.walk(bench_py_function(name))
            if isinstance(node, ast.Assign)
            and isinstance(node.targets[0], ast.Subscript)
            and getattr(node.targets[0].value, "id", None) == "results"}


def assert_same(js, ts, where=""):
    assert js._fields == ts._fields
    for field in js._fields:
        j = np.asarray(getattr(js, field))
        t = getattr(ts, field).numpy()
        if j.dtype == np.uint32:
            j = j.view(np.int32)
        assert j.dtype == t.dtype and j.shape == t.shape, (field, where)
        assert np.array_equal(j, t), (field, where)


def state_cls(core):
    return PauliEnvState if isinstance(core, PauliEnvCore) else MatrixEnvState


@pytest.mark.parametrize("family", list(bench.FAMILIES))
def test_step_program_equals_bench_py_scan_body(family):
    gym, kw = bench.FAMILIES[family]
    jc = getattr(jenvs, gym.__name__).from_coupling_map(
        HEAVY_HEX_27, max_depth=128, **kw).core
    tc = bench.family_core(family, "cpu")
    js = jax.jit(jc.reset, static_argnums=(1, 2))(
        jax.random.key(0), B, bench.DIFFICULTY)
    ts = state_from_arrays({f: np.asarray(getattr(js, f))
                            for f in js._fields}, "cpu", cls=state_cls(tc))
    rng = np.random.default_rng(11)
    acts = rng.integers(0, jc.num_actions, (K, B))
    flips = rng.random((K, B)) < 0.5
    keys = jax.random.split(jax.random.key(1), K)
    jstep = jax.jit(jc.step)
    perms = []
    for t in range(K):   # bench.py's body, step by step
        js = jstep(js, jnp.asarray(acts[t], jnp.int32), keys[t],
                   invert_override=(jnp.asarray(flips[t])
                                    if jc.add_inverts else None))
        if isinstance(tc, PauliEnvCore):
            perms.append(np.asarray(js.perm_idx))
    got = bench.run_steps(tc, ts, torch.as_tensor(acts),
                          torch.as_tensor(flips),
                          torch.as_tensor(np.stack(perms)) if perms else None)
    assert_same(js, got, family)
    assert not bool(got.success.all())   # the steps did work


def test_draws_match_bench_py_shapes_and_ranges():
    g = torch.Generator().manual_seed(0)
    matrix = bench.family_core("clifford_27q_heavy_hex", "cpu")
    actions, flips, perms = bench.draw(matrix, 512, 4, g)
    assert actions.shape == flips.shape == (4, 512) and perms is None
    assert int(actions.min()) >= 0
    assert int(actions.max()) < matrix.num_actions
    assert flips.dtype == torch.bool
    assert 0.4 < float(flips.float().mean()) < 0.6
    pauli = bench.family_core("pauli_network_27q", "cpu")
    actions, _, perms = bench.draw(pauli, 512, 4, g)
    assert int(actions.max()) < pauli.num_actions
    assert perms.shape == (4, 512) and perms.dtype == torch.int32
    assert int(perms.max()) < pauli.num_perms


def test_bench_core_is_b_k_over_the_fastest_run(monkeypatch):
    core = PermutationGym.from_coupling_map([(0, 1), (1, 2)], max_depth=16,
                                            device="cpu").core
    ticks = iter([0.0, 3.0, 10.0, 12.0, 20.0, 25.0])   # runs of 3, 2, 5 s
    monkeypatch.setattr(bench, "perf_counter", lambda: next(ticks))
    assert bench.bench_core(core, B=8, K=2, repeats=3) == 8 * 2 / 2.0


def test_main_prints_one_json_line_with_bench_py_keys(capsys):
    bench.cli(["16", "2", "--device", "cpu"])
    captured = capsys.readouterr()
    lines = captured.out.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert set(line) == json_keys("main") | {"card"}
    assert line["card"] == "cpu" and line["value"] > 0
    assert line["vs_baseline"] == round(line["value"] / bench.NORTH_STAR, 4)
    assert bench.NORTH_STAR == 1e7
    assert set(bench.FAMILIES) == family_names("main")
    for name in bench.FAMILIES:   # bench.py's stderr line, one a family
        assert f"  {name}: " in captured.err


def test_bench_fused_runs_each_matrix_family_both_ways(capsys):
    results = bench_fused.main(B=16, K=2, device="cpu")
    assert set(results) == {"clifford", "permutation", "linear"}
    assert all(p > 0 and f > 0 for p, f in results.values())
    out = capsys.readouterr().out
    assert out.count("plain step (bitpack=True)") == 3
    assert out.count("B1 kernel step") == 3


def test_bench_fused_forces_bitpack_for_a_dense_default(capsys,
                                                        monkeypatch):
    """The JAX script's forced-bitpack row, for a family whose default
    core is dense (no 27q family's is)."""
    def dense_core(name, device=None):
        core = bench.family_core(name, device)
        return MatrixEnvCore(core.num_qubits, core.gateset, core.kind,
                             bitpack=False, device=core.device)

    monkeypatch.setattr(bench_fused, "family_core", dense_core)
    results = bench_fused.main(B=16, K=2, device="cpu")
    assert all(p > 0 and f > 0 for p, f in results.values())
    out = capsys.readouterr().out
    assert out.count("plain step (bitpack=False)") == 3
    assert out.count("plain step forced bitpack (W=1)") == 2   # dim 27
    assert out.count("plain step forced bitpack (W=2)") == 1   # dim 54
    assert out.count("B1 kernel step") == 3


def test_mesh_mode_needs_the_card_unless_asked_for_the_cpu():
    """No fallback to the CPU: without CUDA, `--mesh` on the default
    device raises before it joins a process group."""
    import torch.distributed as dist

    assert not torch.cuda.is_available()
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            bench.main_mesh(device=device)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.cli(["--mesh"])
    assert not dist.is_initialized()


def test_scale_core_through_bench_core():
    line = [(i, i + 1) for i in range(126)]
    core = CliffordGym.from_coupling_map(line, max_depth=128,
                                         device="cpu").core
    assert core.W == 8   # 254 rows: the wide kernels' layout
    r = bench.measure_core(core, 4, 2)
    assert r["steps_per_s"] > 0
    assert bool(torch.isfinite(r["state"].reward).all())


# ------------------------------------------------------------------ --mesh
def _mesh_scenario(rank):
    from qiskit_gym_torch.parallel import make_mesh
    from qiskit_gym_torch.parallel.mesh import gather_env_state

    mesh = make_mesh()
    line, results = bench.main_mesh(mesh, device="cpu")
    finals = {}
    for name in bench.FAMILIES:
        r = bench.measure_core(bench.family_core(name, "cpu"), MESH_B,
                               MESH_K, repeats=1, mesh=mesh,
                               generator=torch.Generator().manual_seed(
                                   MESH_SEED))
        finals[name] = {"local": r["state"], "rate": r["steps_per_s"],
                        "gathered": gather_env_state(mesh, r["state"])}
    return {"line": line, "results": results, "finals": finals}


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    return _spawn(tmp_path_factory.mktemp("bench_mesh"), _mesh_scenario)


def test_mesh_mode_runs_on_two_gloo_processes(mesh_runs):
    for out in mesh_runs:
        line = out["line"]
        assert set(line) == json_keys("main_mesh") | {"card"}
        assert line["devices"] == 2
        assert line["hardware"] == "virtual-cpu-mesh"
        assert "VIRTUAL CPU" in line["metric"] and line["value"] > 0
        assert set(out["results"]) == family_names("main_mesh")
        for r in out["results"].values():
            assert r["steps_per_s"] > 0
            assert (r["B"], r["K"]) == (2048 * 2, 32)


@pytest.mark.parametrize("family", list(bench.FAMILIES))
def test_mesh_blocks_gather_to_the_single_process_run(mesh_runs, family):
    single = bench.measure_core(
        bench.family_core(family, "cpu"), MESH_B, MESH_K, repeats=1,
        generator=torch.Generator().manual_seed(MESH_SEED))["state"]
    half = MESH_B // 2
    for rank, out in enumerate(mesh_runs):
        got = out["finals"][family]
        assert got["rate"] > 0
        assert got["local"].batch == half
        block = type(single)(*(x[rank * half:(rank + 1) * half]
                               for x in single))
        for field, a, b in zip(single._fields, got["local"], block):
            assert torch.equal(a, b), (family, rank, field)
        for field, a, b in zip(single._fields, got["gathered"], single):
            assert torch.equal(a, b), (family, rank, field)
