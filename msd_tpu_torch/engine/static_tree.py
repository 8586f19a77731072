"""Static (hand-written) draft trees: the legacy EAGLE tree shapes.

The port of the JAX package's ``engine/static_tree.py`` (reference:
EAGLE/eagle/model/utils.py:115-233 ``generate_tree_buffers`` and
EAGLE/eagle/model/choices.py). A choices list of top-k-index paths fixes
the tree's shape; the structure is numpy, built once, and only the drafted
tokens are data. ``tree_from_tokens`` packs them into the engine's
``Tree``; ``static_plan`` is the per-level layout that
``spec_engine._draft_expand_static`` drafts with.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from msd_tpu_torch.engine.tree import Tree

# the 63-node tree shipped with EAGLE for 7B models (choices.py:1-3): each
# entry is a path of top-k child indices from the root. Tuples, so a
# TreeConfig that holds it stays hashable.
mc_sim_7b_63 = (
    (0,), (1,), (2,), (3,), (0, 0), (0, 1), (0, 2), (1, 0), (1, 1), (2, 0),
    (2, 1), (3, 0), (0, 0, 0), (0, 0, 1), (0, 0, 2), (0, 1, 0), (0, 1, 1),
    (0, 2, 0), (0, 2, 1), (1, 0, 0), (0, 0, 0, 0), (0, 0, 0, 1),
    (0, 0, 0, 2), (0, 0, 0, 0, 0), (0, 0, 0, 0, 1), (0, 0, 1, 0),
    (0, 0, 1, 1), (0, 1, 0, 0), (0, 0, 0, 0, 2), (0, 0, 0, 1, 0),
    (0, 0, 0, 0, 0, 0), (0, 0, 0, 0, 0, 1), (0, 1, 0, 1), (0, 0, 1, 0, 0),
    (0, 0, 0, 0, 0, 2), (0, 0, 0, 1, 1), (0, 0, 0, 0, 1, 0),
    (0, 0, 0, 0, 0, 0, 0), (0, 0, 0, 0, 0, 0, 1), (0, 2, 0, 0),
    (0, 0, 0, 0, 0, 1, 0), (0, 0, 0, 0, 0, 0, 2), (0, 0, 0, 0, 2, 0),
    (1, 0, 0, 0), (0, 0, 0, 0, 0, 0, 0, 0), (0, 0, 0, 0, 0, 0, 0, 1),
    (0, 0, 0, 0, 0, 0, 1, 0), (0, 1, 1, 0), (0, 0, 0, 0, 0, 0, 0, 2),
    (0, 0, 0, 0, 0, 2, 0), (0, 0, 0, 0, 0, 0, 0, 0, 0),
    (0, 0, 0, 0, 0, 0, 0, 0, 1), (0, 0, 0, 2, 0),
    (0, 0, 0, 0, 0, 0, 0, 1, 0), (0, 0, 0, 0, 0, 0, 0, 0, 2),
    (0, 0, 2, 0), (0, 0, 0, 0, 0, 0, 0, 0, 0, 0), (0, 0, 1, 2),
    (0, 0, 0, 0, 0, 0, 0, 0, 1, 0), (0, 0, 0, 0, 0, 0, 0, 0, 0, 1),
    (0, 1, 0, 2), (0, 0, 0, 0, 0, 0, 0, 0, 0, 2), (0, 0, 0, 0, 1, 1),
)


def _sorted(choices: Sequence[Sequence[int]]):
    return sorted((tuple(p) for p in choices), key=lambda p: (len(p), p))


def choices_to_structure(choices: Sequence[Sequence[int]]
                         ) -> Tuple[np.ndarray, np.ndarray, int]:
    """Sort paths (depth-major, then lexicographic) and derive parents.

    Returns (parents [N], depths [N], n) with node 0 the root; node i>0 is
    choices_sorted[i-1]'s endpoint (generate_tree_buffers:121-150).
    """
    index_of = {(): 0}
    parents = [0]
    depths = [0]
    for path in _sorted(choices):
        parent = index_of[path[:-1]]
        index_of[path] = len(parents)
        parents.append(parent)
        depths.append(len(path))
    return (np.asarray(parents, np.int32), np.asarray(depths, np.int32),
            len(parents))


def static_layout(choices: Sequence[Sequence[int]], max_path_len: int
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(parents, depths, ancestor_mask [N,N], retrieve [N, max_path_len])."""
    parents, depths, n = choices_to_structure(choices)
    mask = np.eye(n, dtype=bool)
    retrieve = np.full((n, max_path_len), -1, np.int32)
    retrieve[0, 0] = 0
    for i in range(1, n):
        mask[i] |= mask[parents[i]]
        retrieve[i] = retrieve[parents[i]]
        retrieve[i, depths[i]] = i
    return parents, depths, mask, retrieve


def tree_from_tokens(choices: Sequence[Sequence[int]],
                     root_token: torch.Tensor, child_tokens: torch.Tensor,
                     max_path_len: int) -> Tree:
    """Instantiate a static tree with drafted tokens.

    child_tokens: [N-1] draft tokens in the sorted-choices node order (node
    i corresponds to sorted path i-1).
    """
    parents, depths, mask, retrieve = static_layout(choices, max_path_len)
    n = len(parents)
    dev = child_tokens.device
    tokens = torch.cat([root_token.reshape(1).to(torch.int32),
                        child_tokens[:n - 1].to(torch.int32)])

    def t(a):
        return torch.from_numpy(a).to(dev)

    return Tree(tokens=tokens, parents=t(parents), mask=t(mask),
                positions=t(depths), retrieve=t(retrieve),
                valid=torch.ones(n, dtype=torch.bool, device=dev))


def per_depth_structure(choices: Sequence[Sequence[int]]):
    """Static per-depth frontier structure for static-tree drafting.

    Returns (parents, depths, n, levels) where levels[d] (d >= 1) is a list
    of (node_id, parent_id, child_slot) for the nodes at depth d, in tree
    order. child_slot is the top-k index the node takes from its parent's
    distribution (the last element of its choices path).
    """
    parents, depths, n = choices_to_structure(choices)
    levels = {}
    for i, path in enumerate(_sorted(choices), start=1):
        levels.setdefault(len(path), []).append(
            (i, int(parents[i]), int(path[-1])))
    return parents, depths, n, levels


class Level(NamedTuple):
    """One depth of a static tree, as index tensors on the device."""

    depth: int
    first: int                   # node id of the level's first node
    width: int                   # its node count (contiguous ids)
    parent_row: torch.Tensor     # [W] row of each parent in depth - 1
    slot: torch.Tensor           # [W] rank the node takes from its parent
    anc: torch.Tensor            # [W, n] ancestor mask rows (self incl.)


class StaticPlan(NamedTuple):
    n: int                       # static node count incl. the root
    max_slot: int                # ranks each parent's top-k must cover
    levels: Tuple[Level, ...]    # depth 1, 2, ... in order
    tree: Tree                   # the structure padded to num_nodes;
    #                              tokens all -1


@functools.lru_cache(maxsize=None)
def static_plan(choices: tuple, max_path_len: int, num_nodes: int,
                device: str) -> StaticPlan:
    """The drafting layout of ``choices``, built once per (choices, path
    length, node budget, device): the levels' gather indices in place of
    the JAX package's per-node updates, and the static part of the tree,
    padded from the static node count n to ``num_nodes`` (dead slots: token
    -1, parent 0, depth 1, self-mask only, invalid)."""
    parents, depths, mask, retrieve = static_layout(choices, max_path_len)
    _, _, n, levels = per_depth_structure(choices)
    if n > num_nodes or len(levels) + 1 > max_path_len:
        raise ValueError(f"static tree of {n} nodes and depth "
                         f"{len(levels)} does not fit num_nodes={num_nodes}, "
                         f"max_path_len={max_path_len}")

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    out, row_of = [], {0: 0}
    for d in sorted(levels):
        nodes, pars, slots = zip(*levels[d])
        out.append(Level(d, nodes[0], len(nodes),
                         t(np.asarray([row_of[p] for p in pars], np.int64)),
                         t(np.asarray(slots, np.int64)),
                         t(mask[list(nodes)])))
        row_of = {node: i for i, node in enumerate(nodes)}
    pad = num_nodes - n
    tree = Tree(
        tokens=t(np.full(num_nodes, -1, np.int32)),
        parents=t(np.concatenate([parents, np.zeros(pad, np.int32)])),
        mask=t(np.pad(mask, ((0, pad), (0, pad)))
               | np.eye(num_nodes, dtype=bool)),
        positions=t(np.concatenate([depths, np.ones(pad, np.int32)])),
        retrieve=t(np.concatenate([retrieve, np.full(
            (pad, max_path_len), -1, np.int32)])),
        valid=t(np.arange(num_nodes) < n))
    max_slot = 1 + max(int(c[-1]) for c in choices)
    return StaticPlan(n, max_slot, tuple(out), tree)
