"""The port's entry points (`qiskit_gym_torch/tools/entry.py`)
against the JAX package's `__graft_entry__.py`, on the CPU.

`entry(device="cpu")`'s step is held against `__graft_entry__.entry()`'s
`forward_step` on the JAX reset state, with the JAX params converted by
`params_from_jax` and JAX's own draws injected (the Gumbel noise of
`jax.random.categorical` and the step's inversion coin-flips): the value
within 1e-5, the reward and every field of the new state bit for bit.
`dryrun_multichip(4)` runs one sharded PPO step and the eval over a
(2, 2) mesh of gloo processes, and the watchdog turns a hung child into a
RuntimeError."""

import math
import re
import sys

import jax
import numpy as np
import pytest
import torch

from qiskit_gym_torch.examples._common import REPO
from qiskit_gym_torch.models import params_from_jax
from qiskit_gym_torch.ops.matrix_env import state_from_arrays
from qiskit_gym_torch.tools import entry as tentry

sys.path.insert(0, REPO)
import __graft_entry__ as graft  # noqa: E402


def test_entry_step_matches_graft_entry_forward_step():
    jfn, (params, jstate, key) = graft.entry()
    jreward, jvalue, jnew = jax.jit(jfn)(params, jstate, key)
    fn, (policy, _, generator) = tentry.entry(device="cpu")
    assert tentry.B == jstate.a.shape[0] == 64
    policy.module.load_state_dict(
        params_from_jax(jax.tree.map(np.asarray, params)))
    state = state_from_arrays({f: np.asarray(getattr(jstate, f))
                               for f in jstate._fields}, "cpu")
    # forward_step's draws: categorical = argmax(gumbel(k_act) + logits),
    # and the step's flip from k_step
    k_act, k_step = jax.random.split(key)
    gumbel = jax.random.gumbel(k_act, (64, policy.num_actions))
    flip = jax.random.bernoulli(k_step, 0.5, (64,))
    reward, value, new = fn(policy, state, generator,
                            gumbel=torch.as_tensor(np.array(gumbel)),
                            flip=torch.as_tensor(np.array(flip)))
    np.testing.assert_allclose(value.numpy(), np.asarray(jvalue), atol=1e-5)
    np.testing.assert_array_equal(reward.numpy(), np.asarray(jreward))
    for field in jnew._fields:
        j = np.asarray(getattr(jnew, field))
        j = j.view(np.int32) if j.dtype == np.uint32 else j
        np.testing.assert_array_equal(getattr(new, field).numpy(), j,
                                      err_msg=field)
    assert not np.array_equal(np.asarray(jnew.a), np.asarray(jstate.a))


def test_entry_runs_on_its_own_draws():
    fn, args = tentry.entry(device="cpu")
    policy, state, _ = args
    assert policy.module.embeddings.out_features == 512   # the flagship
    reward, value, new = fn(*args)
    assert reward.shape == value.shape == (64,)
    assert bool(torch.isfinite(value).all())
    assert torch.equal(new.depth, state.depth - 1)


def test_dryrun_multichip_on_a_2x2_mesh(capsys):
    tentry.dryrun_multichip(4)
    out = capsys.readouterr().out
    m = re.search(r"dryrun_multichip\(4\): mesh=\{'dp': 2, 'mp': 2\} "
                  r"loss=(\S+) steps=(\d+) eval=(\S+) ok", out)
    assert m, out
    assert math.isfinite(float(m.group(1))) and int(m.group(2)) > 0


def test_watchdog_turns_a_hung_child_into_an_error():
    with pytest.raises(RuntimeError, match="watchdog"):
        tentry.run_watched([[sys.executable, "-c",
                             "print('waiting', flush=True); "
                             "import time; time.sleep(60)"]], timeout=3)


def test_a_failed_child_is_an_error_with_its_output():
    with pytest.raises(RuntimeError, match="boom"):
        tentry.run_watched(
            [[sys.executable, "-c", "print('ok')"],
             [sys.executable, "-c", "raise SystemExit('boom')"]], timeout=60)
