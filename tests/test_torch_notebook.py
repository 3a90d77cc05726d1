"""The port's tour notebook (`qiskit_gym_torch/examples/intro.ipynb`) against
the JAX package's (`examples/intro.ipynb`), on the CPU.

(a) It has the JAX notebook's cells, one for one and of the same types, and
    each code cell equals its JAX counterpart, up to whitespace, once the
    substitutions of `SUBSTITUTIONS` are applied: the package name, the
    first cell's `MODELS`/`DEVICE`/`OUT` lines, the shipped artifacts read
    from `MODELS`, the run directories under `OUT`, and `device=DEVICE` on
    every gym and every `RLSynthesis.from_config_json`.
(b) Every code cell runs against the port with `DEVICE = "cpu"` and `OUT` a
    temporary directory, every assert in it passing; it writes only under
    `OUT` and leaves `examples/models/` as it was. With no device given,
    `DEVICE = "cuda"` raises where there is no card.
(c) The manual-stepping cells (3-12) print the same text and give the same
    values (the observations, the rewards exactly, the final flags) as the
    JAX notebook's cells on the CPU, with gymnasium and without it.
(d) The deterministic Pauli cell (42) gives the same gate list in both
    packages.

The cells run through `qiskit_gym_torch.examples.notebook.run_cells`, which
executes their source from the notebook's JSON (no Jupyter).
"""

import hashlib
import os
import re

import numpy as np
import pytest
import torch

from qiskit_gym_torch.envs import adapters
from qiskit_gym_torch.examples.notebook import NOTEBOOK, read_cells, run_cells

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
JAX_NOTEBOOK = os.path.join(ROOT, "examples", "intro.ipynb")
MODELS_DIR = os.path.join(ROOT, "examples", "models")
MANUAL = range(3, 13)       # the manual-stepping cells
PAULI = 42                  # the deterministic Pauli synth
SETUP = ('from qiskit_gym_torch.examples._common import MODELS, run_path '
         'DEVICE = "cuda" # the H100; "cpu" for the plain-PyTorch path '
         'OUT = run_path(None, "intro_nb") # runs/torch/intro_nb: the tour '
         'writes here')

# (JAX text, port text), applied in order to each JAX code cell with its
# whitespace collapsed to single spaces; a pattern is a regular expression
# where it is compiled, else plain text
SUBSTITUTIONS = [
    ("qiskit_gym_tpu", "qiskit_gym_torch"),
    ("AlphaZeroConfig, BasicPolicyConfig, EvalConfig, PPOConfig, "
     "RLSynthesis)",
     "AlphaZeroConfig, BasicPolicyConfig, EvalConfig, PPOConfig, "
     f"RLSynthesis) {SETUP}"),
    ('"models/', 'f"{MODELS}/'),
    ('"runs/', 'f"{OUT}/'),
    ("from_coupling_map(LINE_3)", "from_coupling_map(LINE_3, device=DEVICE)"),
    ("from_coupling_map(GRID_3X3)",
     "from_coupling_map(GRID_3X3, device=DEVICE)"),
    ('basis_gates=["CX"])', 'basis_gates=["CX"], device=DEVICE)'),
    ('("S", (0,)), ], )', '("S", (0,)), ], device=DEVICE, )'),
    (re.compile(r'(from_config_json\([^()]*\.pt")\)'), r"\1, device=DEVICE)"),
]


def _squash(text: str) -> str:
    return " ".join(text.split())


def _sha256_tree(path: str) -> dict:
    digest = {}
    for dirpath, _, files in os.walk(path):
        for name in files:
            full = os.path.join(dirpath, name)
            with open(full, "rb") as f:
                digest[os.path.relpath(full, path)] = hashlib.sha256(
                    f.read()).hexdigest()
    return digest


def test_cells_follow_the_jax_notebook_one_for_one():
    jax_cells, cells = read_cells(JAX_NOTEBOOK), read_cells(NOTEBOOK)
    assert len(cells) == len(jax_cells) == 44
    assert [k for k, _ in cells] == [k for k, _ in jax_cells]
    used = [0] * len(SUBSTITUTIONS)
    for index, ((kind, want), (_, got)) in enumerate(zip(jax_cells, cells)):
        if kind != "code":
            continue
        want = _squash(want)
        for i, (old, new) in enumerate(SUBSTITUTIONS):
            if isinstance(old, str):
                used[i] += want.count(old)
                want = want.replace(old, new)
            else:
                want, n = old.subn(new, want)
                used[i] += n
        assert _squash(got) == want, f"code cell {index}"
    assert all(used), "a substitution that no cell needs"
    # the markdown states no TPU figure and names the card
    text = " ".join(src for kind, src in cells if kind == "markdown")
    assert "TPU" not in text and "H100" in text and "PERF.md" in text


def test_every_cell_runs_on_the_cpu_and_writes_only_under_out(tmp_path,
                                                             monkeypatch):
    cwd, out = tmp_path / "cwd", tmp_path / "out"
    cwd.mkdir()
    monkeypatch.chdir(cwd)
    before = _sha256_tree(MODELS_DIR)
    runs = {r.index: r for r in run_cells(device="cpu", out=str(out))}
    code = [i for i, (kind, _) in enumerate(read_cells(NOTEBOOK))
            if kind == "code"]
    assert sorted(runs) == code
    assert "round-trip ok" in runs[25].stdout
    assert runs[31].value is True
    assert "phase-exact: True" in runs[38].stdout
    assert runs[40].value is not None and runs[PAULI].value is not None
    assert runs[40].section == "AlphaZero / MCTS solve"
    for run_dir in ("intro_perm_3x3", "intro_lf_5_line",
                    "intro_clifford_custom"):
        assert (out / run_dir / "metrics.jsonl").is_file()
    assert (out / "intro_clifford_custom" / "model.pt").is_file()
    assert not os.listdir(cwd)
    assert _sha256_tree(MODELS_DIR) == before


def test_device_cuda_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        for _ in run_cells(only={1, 3}):
            pass


@pytest.mark.parametrize("gymnasium", [True, False],
                         ids=["gymnasium", "no_gymnasium"])
def test_manual_stepping_cells_match_the_jax_notebook(gymnasium,
                                                      monkeypatch):
    only = {1, *MANUAL}
    want = list(run_cells(JAX_NOTEBOOK, only=only))
    if not gymnasium:       # the adapter's own stand-ins for the spaces
        monkeypatch.setattr(adapters, "spaces", None)
        monkeypatch.setattr(adapters, "gym", None)
    got = list(run_cells(device="cpu", only=only))
    assert [r.index for r in got] == [r.index for r in want] == sorted(only)
    for g, w in zip(got, want):
        assert g.stdout == w.stdout, f"cell {g.index}"
        assert repr(g.value) == repr(w.value), f"cell {g.index}"
    got, want = ({r.index: r for r in runs} for runs in (got, want))
    if not gymnasium:
        assert isinstance(got[8].value, adapters._Discrete)
    obs, reward, is_final = got[10].value
    jobs, jreward, jis_final = want[10].value
    np.testing.assert_array_equal(obs, jobs)
    assert obs.dtype == jobs.dtype
    assert reward == jreward and is_final == jis_final
    assert "reward=0.969700001180172, final=True" in got[11].stdout


def test_deterministic_pauli_cell_gives_the_jax_gate_list(monkeypatch):
    got = list(run_cells(device="cpu", only={1, PAULI}))[-1].value
    monkeypatch.chdir(os.path.join(ROOT, "examples"))   # "models/..." there
    want = list(run_cells(JAX_NOTEBOOK, only={1, PAULI}))[-1].value
    assert [tuple(i) for i in got.data] == [tuple(i) for i in want.data]
    assert got.num_qubits == want.num_qubits == 5
