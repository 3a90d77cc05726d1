"""`qiskit_gym_torch.rl.rollout.sample_action` against the JAX package's
`qiskit_gym_tpu.rl.rollout.sample_action`, on the CPU.

- The deterministic path (the masked argmax) equals the JAX function bit for
  bit on numpy-seeded logits with masked actions, tied maxima (the first one
  wins) and a row with every action masked (action 0).
- The sampled path is the collectors' Gumbel-max: it equals the masked
  argmax of the logits plus `draw_gumbel`'s noise drawn from a clone of the
  same generator, never draws a masked action, and over 20,000 draws its
  frequencies match the masked softmax within 5 standard errors.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qiskit_gym_tpu.rl import rollout as jax_rollout
from qiskit_gym_torch.rl import rollout

CPU = types.SimpleNamespace(device=torch.device("cpu"))   # a core's device


def _inputs(seed: int, B: int = 64, A: int = 12):
    """float32 logits [B, A] with some tied maxima, masks with about a third
    of the actions masked, every row with one action left but the last,
    which has none."""
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(B, A)).astype(np.float32)
    ties = rng.random(B) < 0.5
    j = rng.integers(0, A - 1, B)
    # the row's maximum repeated one column to the right
    logits[ties, j[ties] + 1] = logits[ties, j[ties]] = (
        logits[ties].max(axis=1) + 1.0)
    masks = rng.random((B, A)) > 0.3
    masks[np.arange(B), rng.integers(0, A, B)] = True
    masks[-1] = False
    return logits, masks


def _generator(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def _clone(g: torch.Generator) -> torch.Generator:
    c = torch.Generator()
    c.set_state(g.get_state())
    return c


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_deterministic_equals_the_jax_argmax(seed):
    logits, masks = _inputs(seed)
    want = np.asarray(jax_rollout.sample_action(
        None, jnp.asarray(logits), jnp.asarray(masks), True))
    got = rollout.sample_action(torch.from_numpy(logits),
                                torch.from_numpy(masks), True)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[-1] == 0                     # every action masked
    tied = (logits == logits.max(axis=1, keepdims=True)).sum(axis=1) > 1
    assert tied.any()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sample_is_the_gumbel_max_of_draw_gumbel(seed):
    logits, masks = _inputs(seed)
    lt, mt = torch.from_numpy(logits), torch.from_numpy(masks)
    g = _generator(100 + seed)
    twin = _clone(g)
    got = rollout.sample_action(lt, mt, False, generator=g)
    masked = torch.where(mt, lt, torch.finfo(lt.dtype).min)
    want = torch.argmax(masked + rollout.draw_gumbel(
        CPU, twin, lt.shape), dim=-1)
    assert torch.equal(got, want)
    # the generator moved on exactly as far as draw_gumbel's draw
    assert torch.equal(g.get_state(), twin.get_state())
    # and the sample is not the argmax
    assert not torch.equal(got, rollout.sample_action(lt, mt, True))


def test_sample_never_draws_a_masked_action():
    logits, masks = _inputs(7, B=512, A=12)
    lt, mt = torch.from_numpy(logits[:-1]), torch.from_numpy(masks[:-1])
    g = _generator(7)
    for _ in range(40):
        a = rollout.sample_action(lt, mt, False, generator=g)
        assert bool(mt.gather(1, a[:, None]).all())


def test_sample_frequencies_match_the_masked_softmax():
    """20,000 draws of one row: each action's frequency within 5 standard
    errors (sqrt(p (1 - p) / N)) of its masked-softmax probability, and no
    masked action drawn."""
    N = 20000
    rng = np.random.default_rng(11)
    row = rng.normal(size=8).astype(np.float32)
    mask = np.array([True, True, False, True, True, False, True, True])
    lt = torch.from_numpy(np.tile(row, (N, 1)))
    mt = torch.from_numpy(np.tile(mask, (N, 1)))
    a = rollout.sample_action(lt, mt, False, generator=_generator(3))
    freq = np.bincount(a.numpy(), minlength=8) / N
    p = np.where(mask, np.exp(row - row.max()), 0.0)
    p /= p.sum()
    se = np.sqrt(p * (1 - p) / N)
    assert np.all(freq[~mask] == 0)
    np.testing.assert_array_less(np.abs(freq - p)[mask], 5 * se[mask])
