"""The port's public surface against the JAX package's.

- Every public name a JAX package `__init__.py` imports or defines exists in
  the port's counterpart module (the JAX files are read with `ast`; nothing
  of them is imported).
- Every core steps the JAX way, `core.step(state, a, invert_override=...,
  actual_override=...)` (plus `perm_idx=` for a core with automorphisms),
  to the state it reaches without the arguments it ignores.
- `Algorithm.params` is a snapshot, and assigning it loads the net, as the
  JAX package's immutable params behave.
"""

import ast
import importlib
import os

import pytest
import torch

from qiskit_gym_torch.envs import (CliffordGym, LinearFunctionGym, PauliGym,
                                   PermutationGym)
from qiskit_gym_torch.ops.lanes import env_step
from qiskit_gym_torch.rl import RLSynthesis

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
JAX_PKG = os.path.join(ROOT, "qiskit_gym_tpu")
INITS = sorted(os.path.relpath(os.path.join(d, "__init__.py"), JAX_PKG)
               for d, _, names in os.walk(JAX_PKG) if "__init__.py" in names)


def _public_names(path: str) -> set:
    tree = ast.parse(open(path).read())
    names = set()
    for node in tree.body:
        if isinstance(node, ast.ImportFrom):
            names |= {a.asname or a.name for a in node.names}
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    names.add(t.id)
                    if t.id == "__all__":
                        names |= set(ast.literal_eval(node.value))
    return {n for n in names if not n.startswith("_")}


@pytest.mark.parametrize("init", INITS)
def test_port_exports_every_public_name_of_the_jax_package(init):
    sub = os.path.dirname(init)
    port = importlib.import_module(
        "qiskit_gym_torch" + ("." + sub.replace(os.sep, ".") if sub else ""))
    names = _public_names(os.path.join(JAX_PKG, init))
    missing = sorted(n for n in names if not hasattr(port, n))
    assert not missing, f"{port.__name__} lacks {missing}"


def test_named_exports_import():
    from qiskit_gym_torch import PauliGym, gym_adapter  # noqa: F401
    from qiskit_gym_torch.envs import decode_pauli_solution  # noqa: F401
    from qiskit_gym_torch.ops import PauliEnvCore, PauliEnvState  # noqa: F401


LINE_3 = [(0, 1), (1, 2)]
LINE_4_BOTH = [(0, 1), (1, 0), (1, 2), (2, 1), (2, 3), (3, 2)]
GYMS = {
    "clifford": lambda: CliffordGym.from_coupling_map(LINE_3, device="cpu"),
    "permutation": lambda: PermutationGym.from_coupling_map(
        [(0, 1), (1, 2), (2, 3)], device="cpu"),
    "linear": lambda: LinearFunctionGym.from_coupling_map(LINE_3,
                                                          device="cpu"),
    "pauli": lambda: PauliGym.from_coupling_map(LINE_4_BOTH, max_rotations=3,
                                                device="cpu"),
}


def _assert_states_equal(a, b, what):
    for name, x, y in zip(a._fields, a, b):
        assert torch.equal(x, y), f"{what}: {name}"


@pytest.mark.parametrize("kind", list(GYMS))
def test_every_core_steps_through_the_same_call(kind):
    core = GYMS[kind]().core
    g = torch.Generator()
    g.manual_seed(3)
    state = core.reset(16, 4, generator=g)
    pauli = hasattr(core, "translate_action")
    for _ in range(6):
        a = torch.randint(0, core.num_actions, (16,), generator=g)
        flips = torch.rand(16, generator=g) < 0.5
        perm = (torch.randint(0, core.num_perms, (16,), generator=g)
                .to(torch.int32) if pauli else None)
        actual = core.translate_action(state, a) if pauli else a
        if pauli:
            want = core.step(state, a, perm_idx=perm)
            got = core.step(state, a, invert_override=flips,
                            actual_override=actual, perm_idx=perm)
        else:
            want = core.step(state, a, invert_override=flips)
            got = core.step(state, a, invert_override=flips,
                            actual_override=actual)
        _assert_states_equal(got, want, kind)
        _assert_states_equal(env_step(core, state, a, flips, perm, actual),
                             want, kind + " via env_step")
        state = want


def test_params_is_a_snapshot_and_assigning_it_loads_the_net(tmp_path):
    rls = RLSynthesis.from_config_json(
        os.path.join(ROOT, "examples", "models", "perm_grid_3x3.json"),
        device="cpu")
    algo = rls.algorithm
    snap = algo.params
    with torch.no_grad():
        for p in algo.policy.module.parameters():
            p.add_(1.0)
    assert all(not torch.equal(snap[k], v) for k, v in algo.params.items()
               if v.is_floating_point())
    algo.params = snap
    for k, v in algo.params.items():
        assert torch.equal(v, snap[k]), k
    assert algo.params[next(iter(snap))] is not snap[next(iter(snap))]
