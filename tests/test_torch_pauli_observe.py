"""The Pauli observation (`ops/pauli_observe.py`) on the CPU: the plain
version against the JAX package's `dense` on the same states, a CPU core
observing through the plain version without a launch, and the wrapper's
operand check refusing what the kernel does not take. The kernel itself is
held against the plain version on the card, in `tests/test_torch_cuda.py`.

The cores: the 27q heavy-hex artifact's (two automorphisms), the same
gateset with no automorphisms (a one-row perm table), a 33-qubit line with
14 rotation slots (3 words a tableau column, 2 a rotation) and IBM's
127-qubit Eagle map (8 and 4 words). The JAX package searches automorphisms
by plain backtracking, which does not end at 127 qubits, so there it is
handed the port's. States come from reset at difficulty 64 and three random
steps, both automorphisms drawn, and the last of them with its active set
replaced by random subsets of every size from 0 to RT."""

import functools
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qiskit_gym_tpu.ops.pauli import PauliEnvCore as JaxCore
from qiskit_gym_tpu.ops.pauli import PauliEnvState as JaxState
from qiskit_gym_tpu.spec import symmetry as jax_symmetry
from qiskit_gym_torch.envs.coupling_maps import eagle_127q
from qiskit_gym_torch.ops import pauli_observe as po
from qiskit_gym_torch.ops.pauli import PauliEnvCore
from qiskit_gym_torch.utils import profiling

MODELS = os.path.join(os.path.dirname(__file__), "..", "examples", "models")
ONE_Q = ("H", "S", "Sdg", "SX", "SXdg")
B = 6


def _artifact_kwargs():
    with open(os.path.join(MODELS, "pauli_heavy_hex_27q.json")) as f:
        env = json.load(f)["env"]
    kw = {k: env[k] for k in ("num_qubits", "max_depth", "max_rotations",
                              "pauli_diff_scale") if k in env}
    kw["gateset"] = [(g[0], tuple(g[1])) for g in env["gateset"]]
    return kw


def _coupled(n, edges):
    """Every 1q gate on every qubit and CX both ways on every coupler."""
    gs = [(g, (q,)) for g in ONE_Q for q in range(n)]
    return gs + [("CX", e) for a, b in edges for e in ((a, b), (b, a))]


CASES = {
    "heavy_hex_27q": lambda: _artifact_kwargs(),
    "heavy_hex_27q_trivial": lambda: dict(_artifact_kwargs(),
                                          add_perms=False),
    "line33": lambda: dict(num_qubits=33, max_rotations=12, gateset=_coupled(
        33, [(q, q + 1) for q in range(32)])),
    "eagle_127q": lambda: dict(num_qubits=127,
                               gateset=_coupled(127, eagle_127q())),
}


@functools.lru_cache(maxsize=None)
def cores(case):
    kw = CASES[case]()
    tc = PauliEnvCore(device="cpu", **kw)
    with pytest.MonkeyPatch.context() as mp:
        if case == "eagle_127q":
            mp.setattr(jax_symmetry, "coupling_automorphisms",
                       lambda num_qubits, gateset: tc.qubit_perms)
        jc = JaxCore(**kw)
    return jc, tc


def states(tc, seed=7):
    g = torch.Generator().manual_seed(seed)
    st = tc.reset(B, 64, generator=g)
    out = [st]
    for _ in range(3):
        act = torch.randint(0, tc.num_actions + 1, (B,), generator=g)
        st = tc.step(st, act, generator=g)
        out.append(st)
    for first in range(0, tc.RT + 1, B):
        order = torch.rand((B, tc.RT), generator=g).argsort(dim=1)
        count = (first + torch.arange(B)) % (tc.RT + 1)
        out.append(st._replace(active=order < count[:, None]))
    return out


def to_jax(ts):
    """The JAX package's state of the same bits (packed words as uint32)."""
    return JaxState(**{
        f: jnp.asarray(getattr(ts, f).numpy().view(np.uint32)
                       if f in ("tab", "rx", "rz") else getattr(ts, f).numpy())
        for f in JaxState._fields})


@pytest.mark.parametrize("case", list(CASES))
def test_plain_observe_equals_jax_dense(case):
    jc, tc = cores(case)
    assert (tc.num_perms, tc.W2, tc.Wn, tc.RT) == {
        "heavy_hex_27q": (2, 2, 1, 7), "heavy_hex_27q_trivial": (1, 2, 1, 7),
        "line33": (2, 3, 2, 14), "eagle_127q": (2, 8, 4, 7)}[case]
    pm = np.asarray(jc.perm_mats)[:, :jc.dim, :jc.dim]
    np.testing.assert_array_equal(tc.perm_rows.numpy(), pm.argmax(-1))
    drawn, counts = set(), set()
    for t, ts in enumerate(states(tc)):
        got = po.pauli_observe_plain(tc, ts)
        assert got.dtype == torch.uint8 and got.shape == (B,) + tc.obs_shape
        np.testing.assert_array_equal(np.asarray(jc.dense(to_jax(ts))),
                                      got.numpy(), err_msg=str(t))
        drawn |= set(ts.perm_idx.tolist())
        counts |= set(ts.active.sum(dim=1).tolist())
    assert drawn == set(range(tc.num_perms))
    assert counts == set(range(tc.RT + 1))


def test_a_cpu_core_observes_through_the_plain_version():
    _, tc = cores("heavy_hex_27q")
    st = states(tc)[1]
    before = po.pauli_observe.launches
    profiling.clear_spans()
    with profiling.recording(), profiling.span("synth"):
        got = tc.dense(st)
    assert torch.equal(got, po.pauli_observe_plain(tc, st))
    assert po.pauli_observe.launches == before
    root, = profiling.spans()
    assert root.counters["pauli_observe.launches"] == 0


def _fault(tc, st, fault):
    """(core, state) with one operand the kernel refuses."""
    if fault == "tab_int64":
        st = st._replace(tab=st.tab.to(torch.int64))
    elif fault == "active_uint8":
        st = st._replace(active=st.active.to(torch.uint8))
    elif fault == "perm_idx_int64":
        st = st._replace(perm_idx=st.perm_idx.to(torch.int64))
    elif fault == "rx_strided":
        st = st._replace(rx=torch.cat([st.rx, st.rx], dim=2)[..., ::2])
    elif fault == "rz_shape":
        st = st._replace(rz=st.rz[:, :-1].contiguous())
    elif fault == "rotations_past_64":
        tc = PauliEnvCore(5, [("H", (0,)), ("CX", (0, 1))],
                          max_rotations=70, device="cpu")
        st = tc.reset(B, 8, generator=torch.Generator().manual_seed(1))
    return tc, st


@pytest.mark.parametrize("fault", [
    "tab_int64", "active_uint8", "perm_idx_int64", "rx_strided", "rz_shape",
    "rotations_past_64"])
def test_the_operand_check_refuses(fault):
    _, tc = cores("heavy_hex_27q")
    st = states(tc)[1]
    po._check(tc, st)   # as the core passes them
    with pytest.raises(ValueError, match="pauli_observe"):
        po._check(*_fault(tc, st, fault))
