"""The port's native automorphism enumerator (`utils/native.py` +
`csrc/vf2.cpp`, built with the host C++ compiler) against its pure-Python
enumerator and the JAX package's `spec/symmetry.py`, on the CPU: the same
sorted automorphism lists on a line, a 3x3 grid and the 27q heavy hex, and
the same twists for a gateset."""

import pytest

from qiskit_gym_tpu.spec import symmetry as jax_symmetry
from qiskit_gym_torch.spec import symmetry
from qiskit_gym_torch.utils import native

HEAVY_HEX_27 = [
    (0, 1), (1, 2), (1, 4), (2, 3), (3, 5), (4, 7), (5, 8), (6, 7), (7, 10),
    (8, 9), (8, 11), (10, 12), (11, 14), (12, 13), (12, 15), (13, 14),
    (14, 16), (15, 18), (16, 19), (17, 18), (18, 21), (19, 20), (19, 22),
    (21, 23), (22, 25), (23, 24), (24, 25), (25, 26),
]
GRID_3x3 = [(0, 1), (1, 2), (3, 4), (4, 5), (6, 7), (7, 8),
            (0, 3), (3, 6), (1, 4), (4, 7), (2, 5), (5, 8)]
LINE_6 = [(i, i + 1) for i in range(5)]
GRAPHS = {"line6": (6, LINE_6), "grid3x3": (9, GRID_3x3),
          "heavy_hex_27": (27, HEAVY_HEX_27)}
COUNTS = {"line6": 2, "grid3x3": 8, "heavy_hex_27": 2}


def _gateset(edges):
    return [("CX", (a, b)) for a, b in edges] + [("CX", (b, a))
                                                 for a, b in edges]


def test_the_library_builds():
    assert native.build() is not None, "no C++ compiler or a failed build"


@pytest.mark.parametrize("name", list(GRAPHS))
def test_native_equals_python_and_jax(name):
    n, edges = GRAPHS[name]
    adj = symmetry._adjacency(n, _gateset(edges))
    before = native.graph_automorphisms.calls
    got = native.graph_automorphisms(n, adj)
    assert native.graph_automorphisms.calls == before + 1
    assert got == sorted(got) and len(got) == COUNTS[name]
    assert got == sorted(symmetry._python_automorphisms(n, adj))
    want = jax_symmetry.coupling_automorphisms(n, _gateset(edges))
    assert symmetry.coupling_automorphisms(n, _gateset(edges)) == want == got
    assert native.graph_automorphisms.calls == before + 2


@pytest.mark.parametrize("name", ["grid3x3", "heavy_hex_27"])
def test_twists_equal_jax(name):
    n, edges = GRAPHS[name]
    gs = _gateset(edges) + [("H", (q,)) for q in range(n)]
    assert (symmetry.compute_qubit_perms(n, gs)
            == jax_symmetry.compute_qubit_perms(n, gs))


def test_without_a_compiler_the_python_path_answers(monkeypatch):
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_TRIED", True)
    n, edges = GRAPHS["grid3x3"]
    before = native.graph_automorphisms.calls
    got = symmetry.coupling_automorphisms(n, _gateset(edges))
    assert native.graph_automorphisms.calls == before
    assert got == jax_symmetry.coupling_automorphisms(n, _gateset(edges))


def test_no_compiler_builds_nothing(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_compiler", lambda: None)
    assert native.build() is None


def test_a_failed_compile_raises_with_the_diagnostics(monkeypatch, tmp_path):
    (tmp_path / "vf2.cpp").write_text("int broken( {\n")
    monkeypatch.setattr(native, "CSRC", tmp_path)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="vf2.cpp"):
        native.build()
    assert not list((tmp_path / "build").glob("*.tmp"))
