"""Policy transfer between envs with different gatesets.

Port of the JAX package's `models/transfer.py`, on the port's state dicts.
Synthesis policies read a gateset-independent observation (the state
encoding depends only on the qubit count and max_rotations), so a policy
trained on one gateset transfers to any superset gateset over the same
qubits by remapping its action head: the head's rows move to the matching
action indices, and actions new to the destination gateset get a floor
logit that the downstream search (entropy bonus, MCTS root noise) can still
explore.

This is the lever that crossed the 27q full-gateset Pauli rotation onset
(docs/TRAINING.md): a 137-action dense-gateset artifact grafted into the
303-action head seeds at its transferred skill level at once.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

Gate = Tuple[str, Tuple[int, ...]]


def _norm(gateset: Sequence) -> list:
    return [(str(name).upper(), tuple(int(q) for q in qs))
            for name, qs in gateset]


def _modules(state_dict: Dict[str, torch.Tensor]) -> Dict[str, list]:
    """Module path -> its parameter keys (`common.0` -> [`common.0.weight`,
    `common.0.bias`])."""
    out: Dict[str, list] = {}
    for k in state_dict:
        out.setdefault(k.rsplit(".", 1)[0], []).append(k)
    return out


def _head(modules) -> str:
    """The action head: the last layer of the `action.{i}` stack."""
    heads = [m for m in modules if m.startswith("action.")]
    if not heads:
        raise ValueError("policy has no action head (action.{i})")
    return max(heads, key=lambda m: int(m.split(".")[1]))


def graft_action_head(dst_params: Dict[str, torch.Tensor],
                      src_params: Dict[str, torch.Tensor],
                      src_gateset: Sequence[Gate],
                      dst_gateset: Sequence[Gate]) -> Dict[str, torch.Tensor]:
    """Return `dst_params` with `src_params` transferred into it.

    The trunk (embeddings, common and hidden head layers) and the value head
    are copied verbatim; the rows of the action head (`action.{n}.weight`
    [A, H] and `.bias` [A]) are scattered to the destination indices of the
    matching gates. Destination actions absent from the source gateset get
    a zero weight row and the minimum source bias, a small but alive
    constant prior.

    Both are state dicts of the same architecture (`BasicPolicy` or
    `Conv1dPolicy` names); `src_gateset` must be a subset of `dst_gateset`
    up to gate-name case and qubit-tuple type."""
    src_gs, dst_gs = _norm(src_gateset), _norm(dst_gateset)
    dst_index = {g: i for i, g in enumerate(dst_gs)}
    missing = [g for g in src_gs if g not in dst_index]
    if missing:
        raise ValueError(
            f"source gateset entries absent from destination: {missing[:4]}"
            + ("..." if len(missing) > 4 else ""))
    rows = torch.tensor([dst_index[g] for g in src_gs], dtype=torch.int64)

    src_mods, dst_mods = _modules(src_params), _modules(dst_params)
    head = _head(src_mods)
    extra = sorted(set(dst_mods) - set(src_mods))
    if extra:
        # a dst-only module would keep its random init and silently break
        # the transferred behavior (identical logits and value on shared
        # actions): architectures must match exactly
        raise ValueError(f"destination policy has modules absent from the "
                         f"source: {extra} (different architecture?)")
    out = {}
    for name, keys in src_mods.items():
        if name not in dst_mods:
            raise ValueError(f"param module {name!r} missing from "
                             "destination policy (different architecture?)")
        if sorted(keys) != sorted(dst_mods[name]):
            raise ValueError(
                f"structure mismatch grafting {name}: source keys "
                f"{sorted(keys)} vs destination {sorted(dst_mods[name])} "
                "(different architecture?)")
        if name == head:
            continue
        for k in keys:
            want, have = tuple(src_params[k].shape), tuple(dst_params[k].shape)
            if have != want:
                # same names but other widths or obs shape would otherwise
                # surface later as an opaque load_state_dict error or a
                # wrong-shaped saved checkpoint
                raise ValueError(
                    f"shape mismatch grafting {k}: source {want} vs "
                    f"destination {have} (different obs shape or layer "
                    "widths?)")
            out[k] = src_params[k].detach().clone()

    w_src = src_params[f"{head}.weight"].detach()
    b_src = src_params[f"{head}.bias"].detach()
    if w_src.shape[0] != len(src_gs):
        raise ValueError(
            f"source action head has {w_src.shape[0]} outputs but "
            f"src_gateset lists {len(src_gs)} gates")
    w_dst = dst_params[f"{head}.weight"]
    if w_dst.shape[0] != len(dst_gs):
        raise ValueError(
            f"destination action head has {w_dst.shape[0]} outputs but "
            f"dst_gateset lists {len(dst_gs)} gates")
    w_new = w_src.new_zeros((len(dst_gs), w_src.shape[1]))
    b_new = torch.full((len(dst_gs),), float(b_src.min()), dtype=b_src.dtype,
                       device=b_src.device)
    rows = rows.to(w_src.device)
    w_new[rows] = w_src
    b_new[rows] = b_src
    out[f"{head}.weight"] = w_new
    out[f"{head}.bias"] = b_new
    return {k: out[k] for k in dst_params}
