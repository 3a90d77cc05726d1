"""The port's qiskit bridge (`quantum/qiskit_interop.py` and the gyms'
`_maybe_from_qiskit`) against the JAX package, on the CPU, through the
fake-qiskit shim `tests/fake_qiskit.py` (neither machine has qiskit): the
converted objects and every gym's encoded state must be identical."""

import numpy as np
import pytest

import fake_qiskit
from qiskit_gym_tpu import envs as jax_envs
from qiskit_gym_tpu.quantum import Circuit as JaxCircuit
from qiskit_gym_tpu.quantum import Clifford as JaxClifford
from qiskit_gym_tpu.quantum import qiskit_interop as jax_interop
from qiskit_gym_torch import envs as port_envs
from qiskit_gym_torch.quantum import Circuit, Clifford, linear_from_circuit
from qiskit_gym_torch.quantum import qiskit_interop

LINE_3 = [[0, 1], [1, 2]]


@pytest.fixture()
def qiskit_shim():
    installed = fake_qiskit.install()
    yield
    if installed:
        fake_qiskit.uninstall()


def _gates(circ):
    return [(g.name, g.qubits, g.params) for g in circ]


def test_from_qiskit_circuit_matches_jax(qiskit_shim):
    from qiskit import QuantumCircuit

    qc = QuantumCircuit(3)
    qc.h(0).cx(0, 1).s(1).rz(0.375, 2).swap(0, 2).sxdg(1).cz(1, 2)
    got = qiskit_interop.from_qiskit(qc)
    assert isinstance(got, Circuit)
    assert _gates(got) == _gates(jax_interop.from_qiskit(qc))


def test_unsupported_gate_and_type_raise_like_jax(qiskit_shim):
    from qiskit import QuantumCircuit

    qc = QuantumCircuit(1)
    qc.t(0)
    with pytest.raises(ValueError, match="Unsupported gate 't'"):
        qiskit_interop.from_qiskit(qc)
    with pytest.raises(TypeError, match="Cannot convert"):
        qiskit_interop.from_qiskit(object())


def test_to_qiskit_round_trip_matches_jax(qiskit_shim):
    circ = Circuit(2).h(0).cx(0, 1).rz(0.25, 1).sdg(0)
    jcirc = JaxCircuit(2).h(0).cx(0, 1).rz(0.25, 1).sdg(0)
    qk = qiskit_interop.to_qiskit(circ)
    jqk = jax_interop.to_qiskit(jcirc)
    assert qk.num_qubits == jqk.num_qubits == 2
    assert ([(i.operation.name, [b.index for b in i.qubits],
              i.operation.params) for i in qk.data]
            == [(i.operation.name, [b.index for b in i.qubits],
                 i.operation.params) for i in jqk.data])
    assert _gates(qiskit_interop.from_qiskit(qk)) == _gates(circ)


def test_clifford_permutation_linear_match_jax(qiskit_shim):
    from qiskit.circuit.library.generalized_gates import (LinearFunction,
                                                          PermutationGate)
    from qiskit.quantum_info import Clifford as QkClifford

    tab = Clifford(Circuit(2).h(0).cx(0, 1).s(1)).tableau
    got = qiskit_interop.from_qiskit(QkClifford(tab))
    want = jax_interop.from_qiskit(QkClifford(tab))
    assert isinstance(got, Clifford) and isinstance(want, JaxClifford)
    assert np.array_equal(got.tableau, want.tableau)
    assert qiskit_interop.from_qiskit(PermutationGate([2, 0, 1])) == \
        jax_interop.from_qiskit(PermutationGate([2, 0, 1])) == [2, 0, 1]
    mat = np.array([[1, 1, 0], [0, 1, 0], [0, 0, 1]])
    got = qiskit_interop.from_qiskit(LinearFunction(mat))
    want = jax_interop.from_qiskit(LinearFunction(mat))
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_without_qiskit_the_error_names_the_port_types(monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "qiskit", None)
    with pytest.raises(ImportError, match="qiskit_gym_torch.quantum"):
        qiskit_interop.from_qiskit(object())


def _pairs(name, **kw):
    return (getattr(jax_envs, name).from_coupling_map(coupling_map=LINE_3,
                                                      **kw),
            getattr(port_envs, name).from_coupling_map(coupling_map=LINE_3,
                                                       device="cpu", **kw))


def test_every_gym_encodes_qiskit_objects_as_jax(qiskit_shim):
    """The reference's user path: get_state (and so synth) on qiskit
    QuantumCircuit / PermutationGate / LinearFunction / Clifford inputs."""
    from qiskit import QuantumCircuit
    from qiskit.circuit.library.generalized_gates import (LinearFunction,
                                                          PermutationGate)
    from qiskit.quantum_info import Clifford as QkClifford

    jenv, tenv = _pairs("PermutationGym")
    assert (tenv.get_state(PermutationGate([2, 0, 1]))
            == jenv.get_state(PermutationGate([2, 0, 1]))
            == tenv.get_state([2, 0, 1]))

    jenv, tenv = _pairs("LinearFunctionGym")
    mat = linear_from_circuit(Circuit(3).cx(0, 1).cx(1, 2))
    assert (tenv.get_state(LinearFunction(mat))
            == jenv.get_state(LinearFunction(mat))
            == tenv.get_state(Circuit(3).cx(0, 1).cx(1, 2)))

    jenv, tenv = _pairs("CliffordGym")
    qk = QuantumCircuit(3)
    qk.h(0).cx(0, 1).s(1)
    ours = Circuit(3).h(0).cx(0, 1).s(1)
    cl = QkClifford(Clifford(ours).tableau)
    assert tenv.get_state(qk) == jenv.get_state(qk) == tenv.get_state(ours)
    assert tenv.get_state(cl) == jenv.get_state(cl) == tenv.get_state(ours)
    # the phase repair reads the qiskit target too
    synth = Circuit(3).h(0).cx(0, 1).s(1)
    fixed = tenv.post_process_synthesis(synth, qk)
    assert Clifford(fixed) == Clifford(ours)

    jenv, tenv = _pairs("PauliGym", max_rotations=2)
    qp = QuantumCircuit(3)
    qp.h(0).cx(0, 1).rz(0.5, 1).s(2).rx(0.25, 2)
    assert tenv.get_state(qp) == jenv.get_state(qp)
    tup = (QkClifford(Clifford(ours).tableau), ["XZI"])
    assert tenv.get_state(tup) == jenv.get_state(tup)
