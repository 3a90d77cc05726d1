"""Batched array-MCTS on the env's device.

Port of the JAX package's `rl/mcts.py`: a fixed-size tree per env lane,
vectorized over the batch. A node pool of num_sims + 1 slots, per-edge PUCT
statistics, selection as a masked descent over the tree's levels, one
expansion per simulation, a masked backward pass. The env itself is the
recurrent function: node states live in device memory and an expansion is
one batched env step (the fused step kernel for the matrix families, the
metrics kernel inside every Pauli step). The tree itself is plain torch
ops, as it is plain XLA ops in the JAX package.

Rewards are accumulated undiscounted along the path (the envs are
finite-horizon with terminal success bonuses), matching AlphaZero's
value-of-state-under-perfect-play semantics.

What differs from the JAX code, with the same results:

- the per-edge statistics of a node lie in ONE tensor `stats`
  [B, N+1, 5, A] (visit count n, total value below the edge w, edge reward
  r, c_puct * prior, child slot or -1), so one gather serves a level of the
  descent;
- a tree of sim + 1 nodes has no path longer than sim + 1, so simulation
  `sim` descends min(max_depth, sim + 1) levels, not max_depth; there is no
  host round-trip inside a search;
- a terminal node never gets a child, so "no child" alone ends the descent;
- the backward pass adds to every edge of the path at once: the edges of a
  path are distinct, so each `n` and `w` entry receives one addend (entries
  off the path receive zeros), and the return below each edge is summed in
  the JAX order, deepest edge first;
- slot sim + 1 is written for every lane; a lane that attached nothing
  never refers to it.

All randomness is drawn up front from one `torch.Generator` on the device
unless the caller injects it (`root_gamma`, `flips`, `perms`): the two
packages draw different numbers from the same seed.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from qiskit_gym_torch.ops.lanes import (draw_step_noise, env_step,
                                        select_lanes)

Tensor = torch.Tensor

# rows of `Tree.stats`
N, W, R, CP, CHILD = range(5)


class Tree(NamedTuple):
    states: object     # env state whose fields are [B, N+1, ...]
    terminal: Tensor   # bool [B, N+1]: the node's state is final
    stats: Tensor      # f32 [B, N+1, 5, A]: n, w, r, c_puct * prior, child


def _tile_node_axis(state, N1: int):
    """env state [B, ...] -> [B, N1, ...] with the root in slot 0. The other
    slots are written before they are read."""
    def tile(x):
        pool = torch.empty((x.shape[0], N1) + x.shape[1:], dtype=x.dtype,
                           device=x.device)
        pool[:, 0] = x
        return pool

    return type(state)(*(tile(x) for x in state))


def _gather_node(states, flat_idx: Tensor):
    """states [B, N1, ...] and flat_idx [B] = b * N1 + slot -> env state
    [B, ...]."""
    return type(states)(*(
        x.reshape((-1,) + x.shape[2:]).index_select(0, flat_idx)
        for x in states))


def _scatter_node(states, slot: int, new_state) -> None:
    """Write env state [B, ...] into slot `slot` of states [B, N1, ...]."""
    for pool, x in zip(states, new_state):
        pool[:, slot] = x


def masked_priors(core, policy, state):
    """(softmax of the masked logits, value, masks) at `state`."""
    logits, value = policy(core.dense(state))
    masks = core.masks(state)
    neg = torch.finfo(logits.dtype).min
    return (torch.softmax(torch.where(masks, logits, neg), dim=-1), value,
            masks)


@torch.no_grad()
def mcts_search(
    core,
    policy,
    root_state,
    num_sims: int,
    c_puct: float,
    max_depth: int,
    dirichlet_alpha: float = 0.3,
    noise_eps: float = 0.0,
    max_expand_depth: int = 1,
    generator: Optional[torch.Generator] = None,
    root_gamma: Optional[Tensor] = None,
    flips: Optional[Tensor] = None,
    perms: Optional[Tensor] = None,
):
    """Run num_sims batched simulations from root_state.

    `policy(obs) -> (logits, value)`. `noise_eps > 0` mixes
    Dirichlet(alpha) exploration noise into the root priors (AlphaZero
    self-play convention; masked actions get no noise). `max_expand_depth >
    1` extends each expansion with a greedy-by-prior truncated rollout of
    that many env steps: only the first stepped node is attached to the
    tree, deeper steps contribute their accumulated reward plus the network
    value at the rollout frontier to the backed-up leaf value.

    `root_gamma` [B, A] injects the Gamma(alpha) draws behind the root
    noise; `flips` bool and `perms` int32 [num_sims, max_expand_depth, B]
    inject the draw of every env step (the inversion coin-flip of a matrix
    core; the next automorphism of the Pauli core). What is absent is drawn
    from `generator`.

    Returns (visit_counts [B, A], root_value [B], root_priors [B, A])."""
    dev = root_state.depth.device
    B = root_state.depth.shape[0]
    A = core.num_actions
    N1 = num_sims + 1
    E = max_expand_depth

    need_perms = perms is None and hasattr(core, "translate_action")
    if flips is None or need_perms:
        f_draw, p_draw = draw_step_noise(core, generator, (num_sims, E, B))
        flips = f_draw if flips is None else flips
        perms = p_draw if perms is None else perms
    flips = flips.to(device=dev, dtype=torch.bool)
    if perms is not None:
        perms = perms.to(device=dev, dtype=torch.int32)

    priors0, value0, masks = masked_priors(core, policy, root_state)
    if noise_eps > 0.0:
        # masked Dirichlet: per-action gammas, zeroed where illegal,
        # renormalized (all-masked rows fall back to the raw priors)
        if root_gamma is None:
            root_gamma = torch._standard_gamma(
                torch.full((B, A), float(dirichlet_alpha), device=dev),
                generator=generator)
        gam = torch.where(masks, root_gamma.to(dev), 0.0)
        tot = gam.sum(-1, keepdim=True)
        noise = torch.where(tot > 0, gam / torch.clamp(tot, min=1e-12),
                            priors0)
        priors0 = (1.0 - noise_eps) * priors0 + noise_eps * noise

    stats = torch.zeros((B, N1, 5, A), device=dev)
    stats[:, :, CHILD] = -1.0
    stats[:, 0, CP] = c_puct * priors0
    terminal = torch.zeros((B, N1), dtype=torch.bool, device=dev)
    terminal[:, 0] = core.is_final(root_state)
    tree = Tree(_tile_node_axis(root_state, N1), terminal, stats)

    base = torch.arange(B, device=dev) * N1        # flat index of each root
    rows = stats.view(B * N1, 5, A)                # a node's statistics
    cells = stats.view(-1)                         # one edge statistic
    root = torch.zeros(B, dtype=torch.int64, device=dev)
    live = torch.ones(B, dtype=torch.bool, device=dev)

    for sim in range(num_sims):
        # ---- SELECT: descend by PUCT until an edge without a child
        # (a lane that has stopped goes on from a valid but meaningless
        # node; `recs` masks what it records)
        node, rec = root, live
        nodes, actions, recs = [], [], []
        for _ in range(min(max_depth, sim + 1)):
            nb, wb, rb, cpb, ch = rows.index_select(0, base + node).unbind(1)
            # an edge without visits has w = 0 and r finite, so q is 0
            # there without a test of n
            q = (rb * nb + wb) / torch.clamp(nb, min=1)
            total = nb.sum(-1, keepdim=True)
            ucb = q + cpb * torch.sqrt(total + 1e-8) / (1.0 + nb)
            action = torch.argmax(ucb, dim=-1)               # [B]
            child = ch.gather(1, action[:, None])[:, 0].to(torch.int64)
            nodes.append(node)
            actions.append(action)
            recs.append(rec)
            rec = rec & (child >= 0)
            node = torch.clamp(child, min=0)
        on_path = torch.stack(recs, dim=1)                   # [B, L]
        path_nodes = torch.stack(nodes, dim=1)
        path_actions = torch.stack(actions, dim=1)
        # the edge to expand is the last recorded (node, action); level 0
        # is always recorded
        last = on_path.sum(dim=1, keepdim=True) - 1
        exp_node = path_nodes.gather(1, last)[:, 0]
        exp_action = path_actions.gather(1, last)[:, 0]

        # ---- EXPAND: env step from the selected edge into slot sim + 1
        leaf_flat = base + exp_node
        leaf_state = _gather_node(tree.states, leaf_flat)
        stepped = env_step(core, leaf_state, exp_action, flips[sim, 0],
                           None if perms is None else perms[sim, 0])
        priors_new, value_new, _ = masked_priors(core, policy, stepped)
        term_new = core.is_final(stepped)

        # a terminal leaf cannot be expanded: nothing is attached there
        attachable = ~terminal.view(-1).index_select(0, leaf_flat)
        r_cell = (leaf_flat * 5 + R) * A + exp_action
        c_cell = r_cell + (CHILD - R) * A
        child_existing = cells.index_select(0, c_cell)
        fresh = attachable & (child_existing < 0)
        _scatter_node(tree.states, sim + 1, stepped)
        terminal[:, sim + 1] = term_new
        stats[:, sim + 1, CP] = c_puct * priors_new
        cells[c_cell] = torch.where(fresh, float(sim + 1), child_existing)
        cells[r_cell] = torch.where(fresh, stepped.reward,
                                    cells.index_select(0, r_cell))

        # value to back up from the expansion point
        if E > 1:
            # truncated greedy rollout below the new node (not attached)
            roll_state = stepped
            alive = ~term_new
            extra_r = torch.zeros(B, device=dev)
            neg = torch.finfo(torch.float32).min
            for d in range(1, E):
                logits_d, _ = policy(core.dense(roll_state))
                act_d = torch.argmax(torch.where(
                    core.masks(roll_state), logits_d, neg), dim=-1)
                nxt = env_step(core, roll_state, act_d, flips[sim, d],
                               None if perms is None else perms[sim, d])
                extra_r = extra_r + torch.where(alive, nxt.reward, 0.0)
                roll_state = select_lanes(alive, nxt, roll_state)
                alive = alive & ~core.is_final(roll_state)
            _, v_front = policy(core.dense(roll_state))
            leaf_value = extra_r + torch.where(alive, v_front, 0.0)
            leaf_value = torch.where(term_new, 0.0, leaf_value)
        else:
            leaf_value = torch.where(term_new, 0.0, value_new)
        g = torch.where(attachable, leaf_value, 0.0)

        # ---- BACKUP: walk the path backwards, accumulating rewards
        # (levels off the path hold valid cells too, and add zeros there)
        n_cell = ((base[:, None] + path_nodes) * 5 + N) * A + path_actions
        edge_r = cells[n_cell + (R - N) * A]                 # [B, L]
        below = []
        for on_d, r_d in zip(reversed(on_path.unbind(1)),
                             reversed(edge_r.unbind(1))):
            # g is the return below this edge; w accumulates it (the edge's
            # own reward is in r), then the edge reward joins it
            below.append(g)
            g = torch.where(on_d, r_d + g, g)
        below = torch.stack(below[::-1], dim=1)
        n_cell = n_cell.reshape(-1)
        cells.index_add_(0, n_cell, on_path.reshape(-1).to(cells.dtype))
        cells.index_add_(0, n_cell + (W - N) * A,
                         torch.where(on_path, below, 0.0).reshape(-1))

    root_n, root_w, root_r = stats[:, 0, N], stats[:, 0, W], stats[:, 0, R]
    root_q = torch.where(
        root_n > 0, (root_r * root_n + root_w) / torch.clamp(root_n, min=1),
        0.0)
    visits = root_n.sum(-1)
    root_value = torch.where(
        visits > 0,
        (root_n * root_q).sum(-1) / torch.clamp(visits, min=1), value0)
    return root_n.clone(), root_value, priors0
