"""Draft-tree container and greedy verification.

The port of the JAX package's ``engine/tree.py`` for the greedy medusa
path: the ``Tree`` record and the cumprod-of-matches greedy acceptance.
OPT-Tree finalisation and speculative-sampling acceptance come with the
drafting modes and sampling mode that use them.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch


class Tree(NamedTuple):
    tokens: torch.Tensor     # [N] int32, tokens[0] = root token; -1 = dead
    parents: torch.Tensor    # [N] int32 parent pointer in tree order (root=0)
    mask: torch.Tensor       # [N, N] bool, mask[i, j]: i attends j (anc+self)
    positions: torch.Tensor  # [N] int32 depth of the node (root=0)
    retrieve: torch.Tensor   # [N, MAX_PATH] int32 root->node path, -1 padded
    valid: torch.Tensor      # [N] bool


def evaluate_greedy(tree: Tree, tree_logits: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Greedy acceptance over target logits [N, V].

    Returns 0-dim tensors (best_row, accept_len, next_token). A draft token
    at path slot j+1 is accepted iff it equals the target argmax at slot j,
    so the committed sequence is the target's greedy continuation. Ties go
    to the lowest index, in the argmax and in the choice of the best row.
    """
    argmax_tok = torch.argmax(tree_logits, dim=-1).to(torch.int32)   # [N]
    retrieve = tree.retrieve.long()                                  # [R, P]
    r_clamped = torch.clamp(retrieve, min=0)
    cand = torch.where(retrieve >= 0, tree.tokens[r_clamped].long(),
                       torch.full_like(retrieve, -1))
    pred = argmax_tok[r_clamped].long()
    match = (cand[:, 1:] == pred[:, :-1]) & (cand[:, 1:] >= 0)
    accept_lens = torch.cumprod(match.to(torch.int32), dim=1).sum(dim=1)
    accept_len = accept_lens.max()
    best = torch.where(accept_len == 0, torch.zeros_like(accept_len),
                       torch.argmax(accept_lens))
    # 1-element index tensors: a 0-dim tensor index may sync with the host
    bonus_node = retrieve[best.reshape(1), accept_len.reshape(1)]
    next_token = argmax_tok[torch.clamp(bonus_node, min=0)][0]
    return best, accept_len, next_token


def accepted_path(tree: Tree, best_node: torch.Tensor) -> torch.Tensor:
    """Retrieve row for a node index: [MAX_PATH] tree indices, -1 padded."""
    return tree.retrieve.index_select(0, best_node.reshape(1))[0]
