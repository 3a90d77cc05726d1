"""The two packages' own reset draws against each other, in distribution.

Every family of the bench (and every eval row of the quality tables)
starts from `core.reset(B, difficulty)` drawn by the package itself:
`jax.random` there, a `torch.Generator` here. The streams differ, so the
states differ lane by lane; what must agree is the distribution of
targets. Both sides draw B = 4096 lanes at each of two fixed seeds from
the 27q heavy-hex Clifford, permutation and Pauli-network cores (Pauli as
bench.py configures it: max_rotations=5, pauli_diff_scale=8) at difficulty
8, and a two-sample test compares, at p >= 1e-3:

- each lane's Hamming distance of its matrix (the Pauli core's tableau)
  from the identity (Kolmogorov-Smirnov);
- `n_gates`, `n_cnots`, `success` and `depth` after reset;
- for Pauli, the number of active rotations, their total weight (qubits
  touched) and the `perm_idx` frequencies (chi-square on the counts).

The seeds are fixed, so the test is deterministic."""

import functools

import jax
import numpy as np
import pytest
import torch
from scipy import stats

from qiskit_gym_torch import envs as tenvs
from qiskit_gym_torch.examples._common import HEAVY_HEX_27
from qiskit_gym_tpu import envs as jenvs

B = 4096
SEEDS = (0, 1)
DIFFICULTY = 8
P_MIN = 1e-3
FAMILIES = {
    "clifford": ("CliffordGym", {}),
    "permutation": ("PermutationGym", {}),
    "pauli": ("PauliGym", {"max_rotations": 5, "pauli_diff_scale": 8}),
}


def hamming(words: np.ndarray, ident: np.ndarray) -> np.ndarray:
    """Bits [B] in which each lane's packed words differ from `ident`."""
    x = np.bitwise_xor(words.view(np.uint32), ident.view(np.uint32)[None])
    return np.unpackbits(x.view(np.uint8), axis=1).sum(axis=1)


def popcount(words: np.ndarray) -> np.ndarray:
    """Set bits of each lane's words, [B, ...] -> [B]."""
    flat = np.ascontiguousarray(words).view(np.uint32).reshape(
        words.shape[0], -1)
    return np.unpackbits(flat.view(np.uint8), axis=1).sum(axis=1)


@functools.lru_cache(maxsize=None)
def samples(family):
    """Per quantity, the JAX and the port's values over every seed."""
    cls, kw = FAMILIES[family]
    jc = getattr(jenvs, cls).from_coupling_map(HEAVY_HEX_27, max_depth=128,
                                               **kw).core
    tc = getattr(tenvs, cls).from_coupling_map(HEAVY_HEX_27, max_depth=128,
                                               device="cpu", **kw).core
    reset = jax.jit(jc.reset, static_argnums=(1, 2))
    ident = tc.ident_pk.numpy()
    out = {}
    for seed in SEEDS:
        js = reset(jax.random.key(seed), B, DIFFICULTY)
        ts = tc.reset(B, DIFFICULTY,
                      generator=torch.Generator().manual_seed(seed))
        j = {f: np.asarray(getattr(js, f)) for f in js._fields}
        t = {f: getattr(ts, f).numpy() for f in ts._fields}
        matrix = "tab" if family == "pauli" else "a"
        for side, s in (("jax", j), ("port", t)):
            q = {"hamming": hamming(s[matrix], ident)}
            for f in ("n_gates", "n_cnots", "success", "depth"):
                q[f] = s[f].astype(np.int64)
            if family == "pauli":
                q["active"] = s["active"].sum(axis=1)
                q["weight"] = popcount((s["rx"] | s["rz"])
                                       * s["active"][:, :, None])
                q["perm_idx"] = s["perm_idx"].astype(np.int64)
            for k, v in q.items():
                out.setdefault(k, {}).setdefault(side, []).append(v)
    return {k: {side: np.concatenate(v) for side, v in sides.items()}
            for k, sides in out.items()}


def chi2_p(a: np.ndarray, b: np.ndarray) -> float:
    """Chi-square p-value of the two samples' counts over their values
    (1.0 where both take one value only)."""
    values = np.union1d(a, b)
    if len(values) == 1:
        return 1.0
    table = np.stack([(a[:, None] == values).sum(0),
                      (b[:, None] == values).sum(0)])
    return float(stats.chi2_contingency(table)[1])


@pytest.mark.parametrize("family", list(FAMILIES))
def test_hamming_distance_from_identity_agrees(family):
    s = samples(family)["hamming"]
    j, t = s["jax"], s["port"]
    assert j.shape == t.shape == (B * len(SEEDS),)
    assert j.mean() > 4   # difficulty 8 moves the targets off the identity
    p = stats.ks_2samp(j, t).pvalue
    assert p >= P_MIN, (family, j.mean(), t.mean(), p)


@pytest.mark.parametrize("field", ["n_gates", "n_cnots", "success", "depth"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_counters_after_reset_agree(family, field):
    s = samples(family)[field]
    j, t = s["jax"], s["port"]
    p = chi2_p(j, t)
    assert p >= P_MIN, (family, field, np.bincount(j), np.bincount(t), p)


@pytest.mark.parametrize("quantity", ["active", "weight", "perm_idx"])
def test_pauli_rotations_and_automorphisms_agree(quantity):
    s = samples("pauli")[quantity]
    j, t = s["jax"], s["port"]
    p = chi2_p(j, t)
    assert p >= P_MIN, (quantity, np.bincount(j), np.bincount(t), p)
