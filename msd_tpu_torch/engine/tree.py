"""Draft-tree container, greedy verification and speculative-sampling
acceptance.

The port of the JAX package's ``engine/tree.py`` for the medusa path: the
``Tree`` record, the cumprod-of-matches greedy acceptance and the lossless
speculative-sampling walk. OPT-Tree finalisation comes with the drafting
modes that use it.
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


def sampling_width(num_nodes: int, top_k: int) -> int:
    """Children tried per depth by ``evaluate_sampling``: the first
    min(N - 1, max(16, top_k)) children of the accepted node."""
    return min(num_nodes - 1, max(16, top_k))


def evaluate_sampling(tree: Tree, tree_probs: torch.Tensor,
                      uniforms: torch.Tensor, gumbel: torch.Tensor,
                      top_k: int = 10
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Speculative-sampling acceptance (temperature > 0); lossless.

    tree_probs: [N, V] processed target distributions per tree node;
    uniforms: [D, K] draws in [0, 1), one per child tried (D = MAX_PATH - 1
    depths, K = ``sampling_width(N, top_k)``); gumbel: [V] Gumbel noise for
    the final token. Walks depths from the root; at the current accepted
    node, tries its first K children in ascending node order, accepting
    child token x iff uniforms[d, i] <= residual[x], and zeroes and
    renormalises the residual on rejection (utils.py:411-450 with q(x) = 1
    for deterministic top-k drafts). The walk is the JAX function's, step
    for step: D x K dependent steps over the [V] residual.

    Returns 0-dim tensors (best_node, accept_len, next_token sampled from
    the final residual as argmax(log(residual) + gumbel)).
    """
    N = tree_probs.shape[0]
    D = tree.retrieve.shape[1] - 1
    K = sampling_width(N, top_k)
    if tuple(uniforms.shape) != (D, K):
        raise ValueError(f"uniforms must be [{D}, {K}], got "
                         f"{tuple(uniforms.shape)}")
    dev = tree_probs.device
    node_idx = torch.arange(N, device=dev)
    live = tree.valid & (tree.tokens >= 0) & (node_idx > 0)
    # 1-element tensors throughout: a 0-dim tensor index may sync
    cur = torch.zeros(1, dtype=torch.long, device=dev)
    acc = torch.zeros(1, dtype=torch.int32, device=dev)
    alive = torch.ones(1, dtype=torch.bool, device=dev)
    residual = tree_probs[0]
    for d in range(D):
        is_child = (tree.parents.long() == cur) & live
        # indices of the first K children in ascending node order, N = none
        child_ids = torch.sort(torch.where(is_child, node_idx, N)).values[:K]
        child_tok = torch.clamp(
            tree.tokens[torch.clamp(child_ids, max=N - 1)], min=0).long()
        advanced = torch.zeros(1, dtype=torch.bool, device=dev)
        for i in range(K):
            j, tok = child_ids[i:i + 1], child_tok[i:i + 1]
            valid_child = (j < N) & alive & ~advanced
            r = uniforms[d, i:i + 1]
            p_tok = residual.index_select(0, tok)
            accept = valid_child & (r <= p_tok)
            reject = valid_child & (r > p_tok)
            # on rejection: zero the token's mass and renormalize
            res_zero = residual.index_fill(0, tok, 0.0)
            res_zero = res_zero / torch.clamp(res_zero.sum(), min=1e-20)
            residual = torch.where(reject, res_zero, residual)
            cur = torch.where(accept, j, cur)
            acc = acc + accept.to(torch.int32)
            advanced = advanced | accept
        # if we advanced, the residual for the NEXT depth is the new node's
        residual = torch.where(advanced, tree_probs.index_select(0, cur)[0],
                               residual)
        alive = alive & advanced
    next_token = torch.argmax(gumbel + torch.log(
        torch.clamp(residual, min=1e-20))).to(torch.int32)
    return cur[0].to(torch.int32), acc[0], next_token
