"""Draft-tree container, greedy verification and speculative-sampling
acceptance.

The port of the JAX package's ``engine/tree.py``: the ``Tree`` record,
OPT-Tree finalisation (``finalize_tree``), the cumprod-of-matches greedy
acceptance and the lossless speculative-sampling walk.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from msd_tpu_torch.configs import TreeConfig

NEG = -1.0  # dead-slot weight: valid path weights are probabilities > 0


class Tree(NamedTuple):
    tokens: torch.Tensor     # [N] int32, tokens[0] = root token; -1 = dead
    parents: torch.Tensor    # [N] int32 parent pointer in tree order (root=0)
    mask: torch.Tensor       # [N, N] bool, mask[i, j]: i attends j (anc+self)
    positions: torch.Tensor  # [N] int32 depth of the node (root=0)
    retrieve: torch.Tensor   # [N, MAX_PATH] int32 root->node path, -1 padded
    valid: torch.Tensor      # [N] bool


def top_k(x: torch.Tensor, k: int):
    """``lax.top_k`` along the last axis: descending, and the lower index
    first on ties (a stable sort; ``torch.topk`` promises no tie order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[..., idx] per lane: x [..., M], idx [..., *I] (the same leading
    dims) -> [..., *I]."""
    lead = x.shape[:-1]
    flat = idx.long().reshape(lead + (-1,))
    return torch.gather(x, -1, flat).reshape(idx.shape)


def finalize_tree(cfg: TreeConfig, root_token: torch.Tensor,
                  weight_mat: torch.Tensor, token_mat: torch.Tensor,
                  parent_mat: torch.Tensor, use_depth: torch.Tensor,
                  extra_mats: Optional[Dict[str, torch.Tensor]] = None,
                  features: Optional[Dict] = None) -> Tree:
    """Select the top-``num_draft`` nodes of the explored frontier and pack
    the tree.

    weight_mat/token_mat/parent_mat: [MAX_DEPTH, TOP_K] path weights,
    tokens and parent slots; use_depth: 0-dim int tensor, layers >= it are
    masked out (the early stop discards the newest layer, cnets.py:
    1429-1437). The global top-``num_draft`` breaks ties depth-major with
    the lower index first, so a parent (whose path weight is never below
    its child's) is selected with its child. A budget above the explored
    frontier (num_nodes - 1 > max_depth * top_k) is dead-padded. The
    ancestor mask is built by doubling the parent relation, the retrieve
    table one-hot by depth; both hold 0/1 and node indices below
    num_nodes, which fp32 products give exactly. With ``features`` (a
    dict) each [D, K] matrix of ``extra_mats`` is gathered into it as an
    [N] fp32 per-node feature (root and dead slots 0). Every argument may
    carry a leading lane dimension (root_token and use_depth [B], the
    matrices [B, D, K]); the tree's fields then do too.
    """
    D, K = cfg.max_depth, cfg.top_k
    N, n_draft = cfg.num_nodes, cfg.num_draft
    dev = weight_mat.device
    lead = weight_mat.shape[:-2]
    depth_idx = torch.arange(D, device=dev)[:, None]
    flat_w = torch.where(depth_idx < use_depth[..., None, None], weight_mat,
                         torch.full_like(weight_mat, NEG)).flatten(-2)
    n_sel = min(n_draft, D * K)
    top_w, top_pos = top_k(flat_w, n_sel)
    if n_sel < n_draft:
        top_w = torch.cat([top_w, top_w.new_full(lead + (n_draft - n_sel,),
                                                 NEG)], dim=-1)
        top_pos = torch.cat([top_pos, top_pos.new_zeros(
            lead + (n_draft - n_sel,))], dim=-1)
    sel_valid = top_w > 0.0
    # topological order: stable sort by depth (dead slots pushed to the end)
    order = torch.sort(torch.where(sel_valid, top_pos // K, D + 1),
                       dim=-1, stable=True).indices
    top_pos = torch.gather(top_pos, -1, order)
    sel_valid = torch.gather(sel_valid, -1, order)
    sel_layer, sel_node = top_pos // K, top_pos % K

    tokens = torch.cat([
        root_token[..., None].to(torch.int32),
        torch.where(sel_valid, _take(token_mat.flatten(-2), top_pos)
                    .to(torch.int32), -1)], dim=-1)
    # (layer, node) -> tree index (1-based after the root). Dead entries
    # go to a spare row D: a dead pad's (layer, node) is (0, 0), and
    # writing it there would re-parent the top depth-1 candidate's subtree
    # onto the root
    scat = torch.where(sel_valid, sel_layer, D) * K + sel_node
    pos_of = torch.zeros(lead + ((D + 1) * K,), dtype=torch.long,
                         device=dev)
    pos_of.scatter_(-1, scat, torch.arange(1, N, device=dev)
                    .expand(scat.shape))
    par_node = _take(parent_mat.flatten(-2), top_pos).long()
    par_ptr = _take(pos_of, torch.clamp(sel_layer - 1, min=0) * K + par_node)
    par_ptr = torch.where(sel_valid & (sel_layer > 0), par_ptr, 0)
    parents = torch.cat([par_ptr.new_zeros(lead + (1,)), par_ptr],
                        dim=-1).to(torch.int32)

    # ancestor mask by doubling: A_2k = A_k @ A_k over the parent one-hot
    # relation plus the identity
    node_idx = torch.arange(N, device=dev)
    parent_onehot = (parents.long()[..., :, None] == node_idx) \
        & (node_idx[:, None] > 0)
    reach = parent_onehot.float() + torch.eye(N, device=dev)
    for _ in range(max(1, D.bit_length())):
        reach = torch.clamp(reach @ reach, max=1.0)
    mask = reach > 0.0
    positions = mask.sum(dim=-1).to(torch.int32) - 1

    # retrieve: slot d of row i holds i's ancestor at depth d
    P = cfg.max_path_len
    depth_onehot = (positions.long()[..., :, None] ==
                    torch.arange(P, device=dev)).float()      # [..., N, P]
    count = reach @ depth_onehot
    val = reach @ (depth_onehot * node_idx[:, None].float())
    retrieve = torch.where(count > 0, val, -1.0).to(torch.int32)

    valid = torch.cat([sel_valid.new_ones(lead + (1,)), sel_valid], dim=-1)
    if features is not None:
        for name, mat in (extra_mats or {}).items():
            vals = torch.where(sel_valid,
                               _take(mat.flatten(-2), top_pos).float(), 0.0)
            features[name] = torch.cat([vals.new_zeros(lead + (1,)), vals],
                                       dim=-1)
    return Tree(tokens=tokens, parents=parents, mask=mask,
                positions=positions, retrieve=retrieve, valid=valid)


def evaluate_greedy(tree: Tree, tree_logits: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Greedy acceptance over target logits [N, V].

    Returns 0-dim tensors (best_row, accept_len, next_token). A draft token
    at path slot j+1 is accepted iff it equals the target argmax at slot j,
    so the committed sequence is the target's greedy continuation. Ties go
    to the lowest index, in the argmax and in the choice of the best row.
    With a leading lane dimension (the tree's fields and the logits
    [B, N, V]) each lane is evaluated alone and the results are [B].
    """
    argmax_tok = torch.argmax(tree_logits, dim=-1).to(torch.int32)  # [.., N]
    retrieve = tree.retrieve.long()                             # [.., R, P]
    r_clamped = torch.clamp(retrieve, min=0)
    cand = torch.where(retrieve >= 0, _take(tree.tokens.long(), r_clamped),
                       torch.full_like(retrieve, -1))
    pred = _take(argmax_tok.long(), r_clamped)
    match = (cand[..., 1:] == pred[..., :-1]) & (cand[..., 1:] >= 0)
    accept_lens = torch.cumprod(match.to(torch.int32), dim=-1).sum(dim=-1)
    accept_len = accept_lens.amax(dim=-1)
    best = torch.where(accept_len == 0, torch.zeros_like(accept_len),
                       torch.argmax(accept_lens, dim=-1))
    bonus_node = _take(accepted_path(tree, best), accept_len[..., None])
    next_token = _take(argmax_tok, torch.clamp(bonus_node, min=0))[..., 0]
    return best, accept_len, next_token


def accepted_path(tree: Tree, best_node: torch.Tensor) -> torch.Tensor:
    """Retrieve row for a node index: [MAX_PATH] tree indices, -1 padded
    ([B, MAX_PATH] for [B] lanes)."""
    ret = tree.retrieve
    idx = best_node.long()[..., None, None].expand(
        best_node.shape + (1, ret.shape[-1]))
    return torch.gather(ret, -2, idx)[..., 0, :]


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
    for step: D x K dependent steps over the [V] residual. With a leading
    lane dimension on every argument each lane walks its own tree.

    Returns 0-dim tensors (best_node, accept_len, next_token sampled from
    the final residual as argmax(log(residual) + gumbel)); [B] with lanes.
    """
    N, V = tree_probs.shape[-2:]
    lead = tree_probs.shape[:-2]
    D = tree.retrieve.shape[-1] - 1
    K = sampling_width(N, top_k)
    if tuple(uniforms.shape[-2:]) != (D, K):
        raise ValueError(f"uniforms must be [{D}, {K}], got "
                         f"{tuple(uniforms.shape)}")
    dev = tree_probs.device
    node_idx = torch.arange(N, device=dev)
    live = tree.valid & (tree.tokens >= 0) & (node_idx > 0)
    parents = tree.parents.long()
    # 1-element trailing dims throughout: a 0-dim tensor index may sync
    cur = torch.zeros(lead + (1,), dtype=torch.long, device=dev)
    acc = torch.zeros(lead + (1,), dtype=torch.int32, device=dev)
    alive = torch.ones(lead + (1,), dtype=torch.bool, device=dev)
    residual = tree_probs[..., 0, :]
    for d in range(D):
        is_child = (parents == cur) & live
        # indices of the first K children in ascending node order, N = none
        child_ids = torch.sort(torch.where(is_child, node_idx, N),
                               dim=-1).values[..., :K]
        child_tok = torch.clamp(_take(tree.tokens, torch.clamp(
            child_ids, max=N - 1)), min=0).long()
        advanced = torch.zeros_like(alive)
        for i in range(K):
            j, tok = child_ids[..., i:i + 1], child_tok[..., i:i + 1]
            valid_child = (j < N) & alive & ~advanced
            r = uniforms[..., d, i:i + 1]
            p_tok = torch.gather(residual, -1, tok)
            accept = valid_child & (r <= p_tok)
            reject = valid_child & (r > p_tok)
            # on rejection: zero the token's mass and renormalize
            res_zero = residual.scatter(-1, tok, 0.0)
            res_zero = res_zero / torch.clamp(
                res_zero.sum(dim=-1, keepdim=True), min=1e-20)
            residual = torch.where(reject, res_zero, residual)
            cur = torch.where(accept, j, cur)
            acc = acc + accept.to(torch.int32)
            advanced = advanced | accept
        # if we advanced, the residual for the NEXT depth is the new node's
        at_cur = torch.gather(tree_probs, -2, cur[..., None].expand(
            lead + (1, V)))[..., 0, :]
        residual = torch.where(advanced, at_cur, residual)
        alive = alive & advanced
    next_token = torch.argmax(gumbel + torch.log(
        torch.clamp(residual, min=1e-20)), dim=-1).to(torch.int32)
    return cur[..., 0].to(torch.int32), acc[..., 0], next_token
