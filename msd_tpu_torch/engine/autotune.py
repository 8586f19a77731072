"""Tree-budget autotuning: the ``total_token = -1`` path.

The port of the JAX package's ``engine/autotune.py``. Reference:
EAGLE/eagle/model/ea_model.py:156-179 times base-model forwards at each
candidate length in {40, 48, 50, 56, 60} and picks the cheapest per
expected token. ``autotune_total_token`` times the verify step's own
target forward (``spec_engine.verify_forward``, window-canonical, as
``_verify`` runs it; the JAX version times a ``tree_bias`` forward, which
the port does not have) at each candidate node count; on the card as a
replayed CUDA graph between CUDA events, since an eager forward would time
the host's dispatch of its ~1000 kernels. ``autotune_tree_alpha`` runs the
real engine per candidate tree and keeps the best measured speedup.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Tuple

import torch

from msd_tpu_torch.configs import EngineConfig, LlamaConfig, TreeConfig
from msd_tpu_torch.engine import spec_engine as SE
from msd_tpu_torch.models import llama as L


def _timing_tree(tree: TreeConfig, n_nodes: int, device) -> SE.Tree:
    """A tree of ``n_nodes`` for the timed forward: top_k nodes per depth
    off the previous depth's first node, as deep as the budget reaches
    within max_depth (the medusa backbone layout; the forward's cost
    depends on the row count and the window, not on the tokens)."""
    t = dataclasses.replace(tree, num_nodes=n_nodes, medusa_widths=None,
                            medusa_choices=None, static_choices=None)
    _, _, par, mask, depth, ret, valid, _, _ = SE._medusa_layout(
        t, t.max_depth - 1, str(device))
    tokens = torch.zeros(n_nodes, dtype=torch.int32, device=device)
    return SE.Tree(tokens=tokens, parents=par, mask=mask, positions=depth,
                   retrieve=ret, valid=valid)


def time_verify_forward(params: Dict, cfg: LlamaConfig, tree: TreeConfig,
                        n_nodes: int, s_target: int, prefix_len: int = 640,
                        repeats: int = 5, device="cuda") -> float:
    """Seconds of one verify forward over ``n_nodes`` tree rows at
    committed length ``prefix_len`` (at most s_target - n_nodes, so the
    rows fit the cache) into a ``s_target``-row cache: the fastest of
    ``repeats``. On a CUDA device a CUDA graph of the forward (captured
    after a warm-up on a side stream), each replay timed with CUDA events;
    on the CPU the eager forward's wall."""
    device = torch.device(device)
    prefix_len = min(prefix_len, s_target - n_nodes)
    dtype = params["embed_tokens"].dtype
    cos_t, sin_t = L.make_rope(cfg, s_target + 64, device)
    kv = L.init_kv_cache(cfg, s_target, dtype, device)
    tr = _timing_tree(tree, n_nodes, device)
    E = torch.full((), prefix_len, dtype=torch.int32, device=device)

    def fwd():
        return SE.verify_forward(params, cfg, kv, E, tr, cos_t, sin_t)

    if device.type != "cuda":
        fwd()
        best = float("inf")
        for _ in range(repeats):
            t0 = time.perf_counter()
            fwd()
            best = min(best, time.perf_counter() - t0)
        return best
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        fwd()
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fwd()
    graph.replay()
    best = float("inf")
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / 1e3)
    return best


def autotune_total_token(params: Dict, cfg: LlamaConfig, eng: EngineConfig,
                         candidates: Tuple[int, ...] = (40, 48, 50, 56, 60,
                                                        96, 128),
                         expected_alpha_fn=None, log=None,
                         device="cuda") -> TreeConfig:
    """Pick the tree budget minimising verify time per expected token.

    expected_alpha_fn(n) estimates the accepted length at budget n; the
    default is the JAX package's saturating proxy n ** 0.25 (relative
    ranking only). Each candidate is timed over the engine's own cache
    capacity for that budget (``Statics.s_target``)."""
    if expected_alpha_fn is None:
        def expected_alpha_fn(n):
            return n ** 0.25

    best, best_n = float("inf"), candidates[0]
    for n in candidates:
        s_target = -128 * (-(eng.max_seq_len + n) // 128)
        t = time_verify_forward(params, cfg, eng.tree, n, s_target,
                                device=device)
        score = t / expected_alpha_fn(n)
        if log:
            log(f"autotune: nodes={n} verify={t * 1e3:.3f}ms "
                f"score={score:.5f}")
        if score < best:
            best, best_n = score, n
    return dataclasses.replace(eng.tree, num_nodes=best_n)


def widths_tree(widths: Tuple[int, ...], base: TreeConfig) -> TreeConfig:
    """TreeConfig for a medusa per-depth width plan."""
    widths = tuple(int(w) for w in widths)
    return dataclasses.replace(base, top_k=widths[0], max_depth=len(widths),
                               num_nodes=1 + sum(widths),
                               medusa_widths=widths)


def autotune_tree_alpha(gen, candidates, ids, img_feats=None,
                        max_new: int = 128, t_ar: float | None = None,
                        repeats: int = 2, log=None, **gen_kw) -> Dict:
    """Alpha-aware budget tuning: run the real engine end to end per
    candidate TreeConfig (``gen.eng`` set to it, which reallocates the
    generator's state), measure (alpha, ms/step; the step's wall is the
    request's, prefill included, over its verify steps, the fastest of
    ``repeats`` after one untimed request that captures), and adopt the
    tree maximising alpha * t_ar / t_step (alpha / t_step without t_ar).
    A medusa width plan deeper than the draft's 1 + medusa_heads depths is
    trimmed to them. ``gen`` is an MSDGenerator, left on the winning
    tree."""
    results = []
    best_score, best_tree = -float("inf"), gen.eng.tree
    heads = gen.dcfg.medusa_heads
    if heads:
        trimmed = []
        for tree in candidates:
            w = tree.medusa_widths
            if w is not None and len(w) > 1 + heads:
                if log:
                    log(f"alpha-tune: plan {w} exceeds the engine's "
                        f"{1 + heads} draftable depths: trimming")
                tree = widths_tree(w[:1 + heads], tree)
            trimmed.append(tree)
        candidates = trimmed
    for tree in candidates:
        gen.eng = dataclasses.replace(gen.eng, tree=tree)
        r = gen.generate(ids, img_feats=img_feats, max_new_tokens=max_new,
                         **gen_kw)
        times = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            r = gen.generate(ids, img_feats=img_feats,
                             max_new_tokens=max_new, **gen_kw)
            times.append(time.perf_counter() - t0)
        t_step = min(times) / max(r.accept_steps, 1)
        alpha = r.avg_accept_len
        score = alpha * (t_ar if t_ar else 1.0) / t_step
        results.append({"tree_nodes": tree.num_nodes,
                        "widths": tree.medusa_widths, "alpha": alpha,
                        "ms_per_step": t_step * 1e3, "score": score})
        if log:
            log(f"alpha-tune: nodes={tree.num_nodes} "
                f"widths={tree.medusa_widths} alpha={alpha:.3f} "
                f"step={t_step * 1e3:.3f}ms "
                f"{'speedup' if t_ar else 'score'}={score:.4f}")
        if score > best_score:
            best_score, best_tree = score, tree
    gen.eng = dataclasses.replace(gen.eng, tree=best_tree)
    return {"picked_nodes": best_tree.num_nodes,
            "picked_widths": best_tree.medusa_widths, "sweep": results}
