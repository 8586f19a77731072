#!/usr/bin/env python3
"""Smoke run of the PyTorch port (msd_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (the run then exits non-zero and
prints no result):

1. device: the card's name and power limit, torch and CUDA versions; fails
   without a CUDA device.
2. build: compiles the port's CUDA kernel with nvcc and prints seconds,
   ptxas usage and shared memory per block.
3. kernels: calls each kernel's wrapper on the card at the main path's
   shapes and at the edges of K1's split grid and holds it against its
   plain PyTorch version (max abs error beside the stated tolerance);
   checks that K1 is bitwise deterministic
   over eager calls and CUDA-graph replays; times kernel, plain version
   and one PyTorch library call with CUDA graphs of launches over 32
   layer-sized caches (each launch finds its cache out of L2, as in a
   decode step) at four kv_len and at kv_len 0 (K1's fixed cost); and,
   last, profiles 32 K1 calls, which must show one kernel launched 32
   times.
4. main path at LLaVA-1.5-7B width (random weights from seeded generators
   on the card): two bench-style image prompts, the shared prefill, the
   fast AR baseline (decode attention through the kernel), greedy medusa
   MSD, and MSD with an independently seeded null draft, first with the
   verify step and the AR token replayed as CUDA graphs (the main path),
   then eagerly (``cuda_graphs=False``). Every graph is captured in an
   untimed warm-up; a capture inside a timed window fails the run. On both
   prompts graph MSD, eager MSD and graph and eager null-draft MSD (the
   canonical greedy AR) must give the same tokens, and graph AR the eager
   AR's; each graph run must have replayed a graph captured for its own
   weights; K1's launch count over each phase (under replay: the calls
   each graph holds x its replays) must equal 32 layers x AR tokens
   decoded. Random drafts are almost never accepted, so MSD then runs once
   more per prompt, on a generator of its own that captures inside the
   block, with an oracle tree holding the null-draft tokens: it must be
   accepted to full depth (14) at every step and still commit the
   null-draft tokens.
5. calib (``run_calib``), on the main path's weights and prompts: a
   collecting run per prompt (features sane: one row per step, every
   non-root node valid, confidences in [0, 1], accepted nodes valid); a fit
   with bench.py's settings; calibrated MSD with the fitted tables, graph
   and eager (equal tokens, steps and accepted tokens); a "demote"
   calibrator that must change the trees; the fitted tables again, which
   must replay their first graph; the calibrated oracle draft, accepted to
   full depth. Every run must commit the null-draft tokens and replay a
   graph that reads its own tables. ms/step and peak memory.
6. sampling (``run_sampling``): T=1 MSD and AR on prompt 0, graph and
   eager: the same seed gives the same tokens under replay and eagerly,
   another seed others; K1 launches = 32 per sampled AR token decoded; the
   speculative-sampling walk keeps the target distribution on the card
   (total variation < 0.05 over 4000 walks).
7. distill (``run_distill``): bench.py's distillation of the draft cut to
   the two prompts and two record -> train rounds, on a generator of its
   own over the main path's target: engine-collected records
   (``generate(collect_hiddens=True)``, whose tokens must equal the
   non-collecting run's), the trainer with bench's settings (lr 1e-3 then
   divided by 3, warmup 20, p_w 0.1, noise_rel 0.01, v_norm, medusa_w 1,
   batch 2 over 768-row records, halving step budgets), and the bf16 cast
   of the trained draft served through ``set_draft``. The trained draft's
   graph-replayed MSD must commit the null-draft tokens, the last round's
   mean loss must be below the first's, and alpha must rise above the
   random draft's. Seconds per step, collection seconds, alpha before and
   after, ms/token of MSD and of the AR baseline on the same generator,
   and peak memory.
8. eagle (``run_eagle``): the JAX package's default drafting mode, EAGLE
   recursion (a one-layer draft without medusa heads, the OPT-Tree
   frontier with its early stop, bench.py's --draft-mode eagle tree: top-k
   10, depth 8, 96 nodes, threshold 0.2), and the other modes, on the
   main path's target and prompts, each verify step a replayed graph and
   each run also eager; every run must commit the null-draft tokens of
   its verify shape. A random draft (with the AR baseline: K1 launches =
   32 per AR token decoded); the same without the stop, whose trees must
   be 8 deep at every step; the draft after one record -> train round
   with bench's settings on its own trajectories (the stop depth must take
   3 or more values), then collected, fitted and calibrated; the
   mc_sim_7b_63 static tree and a 48-node medusa_choices tree; the
   autotuners (the verify forward timed per node budget, three medusa
   width plans run end to end), each re-tuned generator's request equal
   to a fresh generator's. The stop depth is read through a wrapper of
   the verify step that writes each tree's deepest valid node into a
   device buffer. Alpha, ms/step and the stop-depth histogram per run.
9. profiles: one AR and one MSD request (prefill + 16 tokens), graph and
   eager: wall, device time, idle share of the request and of its decode
   range, top kernels; in the graph AR request the profiler must count as
   many K1 launches as the wrapper's count, 32 per AR token decoded; a
   sampled MSD request and the acceptance walk's share of its step; one
   train step of the distillation: device time, the GEMMs' share, and its
   fp32 operations (counted from the shapes) against the card's fp32
   peak; the EAGLE expansion alone against the medusa expansion.

The line before the last is the card's name and power limit; the line
before that a JSON object with one entry per kernel; the last line
{"ok": true, "device": {...}}. Imports nothing of JAX or of msd_tpu.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory (NVIDIA data sheet)
BF16_OPS_PER_S = 989e12       # H100 SXM dense bf16 tensor-core peak
FP32_OPS_PER_S = 67e12        # H100 SXM fp32 peak outside the tensor cores
# K1 against its plain twin, elementwise |out - ref| <= atol + rtol |ref|.
# bf16: both keep scores, probabilities and sums in fp32 and round the
# output once to bf16, so they may differ by one bf16 ulp (at most 2^-7 of
# |ref|); atol 2^-10 covers the summation-order noise of outputs near zero
# (typical |out| is 0.05 at kv_len 640). Earlier chip runs measured at most
# 1.95e-3 = 2^-9, one ulp of an output in [0.25, 0.5).
TOL = {"bfloat16": (2 ** -10, 2 ** -7), "float32": (1e-5, 1e-5)}
# bench.py defaults: 64-token image prompts, KV allocation 1152, medusa
# widths 10,8,...,1 (48-node tree, depth 14), 6 canonical rounding bits,
# lm_head sharpened x6; this run decodes 64 new tokens per prompt
MAX_SEQ, MAX_NEW, N_IMG, PROMPT_TOKENS = 1152, 64, 576, 64
WIDTHS = (10, 8, 6, 5, 4, 3, 2, 2, 2, 1, 1, 1, 1, 1)
ROUND_BITS, HEAD_SHARPEN = 6, 6.0
# bench.py's distill (1700 steps over 5 record -> train rounds) cut to two
# rounds and a step budget that keeps the phase under two minutes on the
# card (~0.5 s a step at 7B width)
DISTILL_STEPS, DISTILL_ROUNDS = 160, 2
# bench.py's --draft-mode eagle tree (bench.py:396-408): OPT-Tree frontier
# of 10 per depth, 8 depths, 96 nodes, early stop at 0.2 (95 draft nodes >
# 8 x 10 explored: the dead-padded budget)
EAGLE_TREE = dict(top_k=10, max_depth=8, num_nodes=96)
# EAGLE's 63-path static tree (mc_sim_7b_63, depth 10) and its budget
STATIC_TREE = dict(top_k=10, max_depth=10, num_nodes=64)
# one record -> train round of the EAGLE draft, short enough that the
# draft stays unsure at some positions (the stop then varies)
EAGLE_TRAIN_STEPS = 100
AUTOTUNE_NODES = (40, 48, 50, 56, 60, 96, 128)   # bench --tree-nodes -1
ALPHA_PLANS = (WIDTHS, (10, 6, 4, 2, 1, 1), (6, 6, 6, 6, 6, 6, 6, 6))
# a cross-product medusa_choices tree within the main draft's 13 heads:
# the backbone of widths 10,6,4,3,2,1,...,1 (34 paths) plus 13 branches
# off ranks 1-3, 47 paths, so its verify has the main path's 48 rows
MEDUSA_CHOICES = tuple(
    (0,) * (d - 1) + (r,)
    for d, w in enumerate((10, 6, 4, 3, 2) + (1,) * 9, 1)
    for r in range(w)) + (
    (1, 0), (2, 0), (3, 0), (1, 1), (1, 0, 0), (2, 0, 0), (0, 1, 0),
    (0, 1, 1), (1, 0, 0, 0), (0, 1, 0, 0), (0, 0, 1, 0), (0, 0, 0, 1, 0),
    (0, 0, 1, 0, 0))


def log(*a):
    print(*a, flush=True)


def smi_name_and_limit() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def phase_device():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script measures the port on an NVIDIA card")
    import msd_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)
    card = smi_name_and_limit()
    log(f"[device] {card} | torch {torch.__version__} | CUDA "
        f"{torch.version.cuda} | {torch.cuda.device_count()} device(s) | "
        f"{sys.version.split()[0]}")
    # fp32 products in full fp32 (the port's attention widens bf16 to fp32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return card


def phase_build():
    """Build the port's one kernel source with nvcc (a plain C library);
    print each kernel instance's registers, spills and shared memory."""
    import re

    import torch
    from msd_tpu_torch.ops import decode_attention as K1
    path, secs, out = K1.build_library()
    log(f"[build] decode_attention: "
        f"{'already built' if secs == 0.0 else f'{secs:.1f}s'} -> "
        f"{path.name}")
    name = None
    for ln in out.splitlines():
        m = re.search(r"decode_kernelI(\w+?)Li(\d)EE", ln)
        if "Compiling entry" in ln and m:
            dtype = "bf16" if "bfloat16" in m.group(1) else "fp32"
            name = f"{dtype} rows={m.group(2)}"
        elif name and ("registers" in ln or "spill" in ln):
            log(f"[build]   {name}: {ln.split(':', 1)[-1].strip()}")
    smem = ", ".join(f"{str(dt)[6:]} rows={r}: {K1.smem_bytes(dt, r)} B"
                     for dt in (torch.bfloat16, torch.float32)
                     for r in (1, 4))
    log(f"[build]   dynamic shared memory per block (stage ring; above "
        f"48 KB through cudaFuncSetAttribute): {smem}")

def graph_ms(fn, n_calls: int, reps: int = 20) -> float:
    """Device ms per call: capture n_calls calls of fn(i) in a CUDA graph,
    replay it reps times between CUDA events (host dispatch excluded)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(3):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(n_calls):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * n_calls)


@contextlib.contextmanager
def phase_walls():
    """Within the block, the generator's ``prefill`` and ``decode`` ranges
    synchronise the card on entry and exit and add their host wall
    seconds to the dict yielded (a measurement aid: the extra syncs are
    not on the timed path)."""
    import torch
    from msd_tpu_torch.engine import generator as G
    walls = {}

    @contextlib.contextmanager
    def timed(name):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        yield
        torch.cuda.synchronize()
        walls[name] = walls.get(name, 0.0) + time.perf_counter() - t0

    record_function = G.record_function
    G.record_function = timed
    try:
        yield walls
    finally:
        G.record_function = record_function


def device_profile(fn, label: str, top: int = 6) -> dict:
    """Run fn() once under torch.profiler (CPU and CUDA activity) and print
    its device time (kernels, copies, fills) and top kernels; where fn runs
    a request, also the device time inside its ``decode`` range (the
    generator's record_function). The profiler adds host cost per op and
    CUPTI adds gaps between the kernels of a graph, so the idle shares are
    taken against the wall of a second, unprofiled run of fn (request and
    decode range), the profiled walls printed beside them."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from msd_tpu_torch.ops import decode_attention as K1
    torch.cuda.synchronize()
    k1_before = K1.decode_attention.launches
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        prof_wall_us = (time.perf_counter() - t0) * 1e6
    k1_counted = K1.decode_attention.launches - k1_before
    with phase_walls() as walls:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.events()
    spans = [(e.time_range.start, e.time_range.end, e.name) for e in events
             if e.device_type == DeviceType.CUDA
             and not getattr(e, "is_user_annotation", False)
             and e.name not in ("prefill", "decode")]
    by_name = {}
    for start, end, name in spans:
        us, n = by_name.get(name, (0.0, 0))
        by_name[name] = (us + end - start, n + 1)
    rows = sorted(((us, n, name) for name, (us, n) in by_name.items()),
                  reverse=True)
    busy_us = sum(r[0] for r in rows)
    tops = "; ".join(f"{name[:48]} x{n}: {us / 1e3:.2f} ms"
                     for us, n, name in rows[:top])
    out = {"wall_us": wall_us, "busy_us": busy_us, "k1_counted": k1_counted,
           "kernels": [(name, n) for _, n, name in rows],
           "kernel_us": {name: us for us, _, name in rows}}
    decode = [e.time_range for e in events if e.name == "decode"
              and e.device_type == DeviceType.CPU]
    extra = ""
    if decode and "decode" in walls:
        d0, d1 = decode[0].start, decode[0].end
        d_busy = sum(max(0.0, min(end, d1) - max(start, d0))
                     for start, end, _ in spans)
        d_wall = walls["decode"] * 1e6
        out.update(decode_us=d_wall, decode_busy_us=d_busy)
        extra = (f"; decode range: wall {d_wall / 1e3:.2f} ms (profiled "
                 f"{(d1 - d0) / 1e3:.2f}), device {d_busy / 1e3:.2f} ms, "
                 f"idle share {1 - d_busy / d_wall:.3f}")
    log(f"[profile] {label}: wall {wall_us / 1e3:.2f} ms (profiled "
        f"{prof_wall_us / 1e3:.2f}), device {busy_us / 1e3:.2f} ms, idle "
        f"share {1 - busy_us / wall_us:.3f}{extra}; top: {tops}")
    return out


def _attn_inputs(t, hq, hkv, s, kv_len, dtype, seed):
    """Seeded inputs on the card; K and V past kv_len are NaN (the kernel
    must never read them), the bias admits every live key."""
    import torch
    from msd_tpu_torch.ops.attention import NEG_INF
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(t, hq, 128, generator=g, device="cuda").to(dtype)
    k = torch.randn(s, hkv, 128, generator=g, device="cuda").to(dtype)
    v = torch.randn(s, hkv, 128, generator=g, device="cuda").to(dtype)
    k[kv_len:] = float("nan")
    v[kv_len:] = float("nan")
    cols = torch.arange(s, device="cuda")
    bias = torch.where(cols < kv_len, 0.0, NEG_INF).float()
    bias = bias[None].expand(t, s).contiguous()
    n = torch.tensor(kv_len, dtype=torch.int32, device="cuda")
    return q, k, v, bias, n


def check_k1(label, q, k, v, bias, n, kv_len) -> float:
    """One launch of K1 against its plain version at the stated
    tolerance; returns the max abs error."""
    import torch
    from msd_tpu_torch.ops import decode_attention as K1
    out = K1.decode_attention(q, k, v, bias, n)
    torch.cuda.synchronize()
    ref = K1.decode_attention_reference(q, k, v, bias, kv_len)
    if not torch.isfinite(out).all():
        raise AssertionError(f"K1 output not finite at {label}")
    diff = (out.float() - ref.float()).abs()
    err = diff.max().item()
    atol, rtol = TOL[str(q.dtype)[6:]]
    excess = (diff - rtol * ref.float().abs()).max().item()
    log(f"[K1] {label}: max_abs_err {err:.3e}, max(|err| - "
        f"{rtol:.1e}|ref|) {excess:.3e} (tol {atol:.1e}), ref rms "
        f"{ref.float().pow(2).mean().sqrt().item():.3e}")
    if not excess <= atol:
        raise AssertionError(f"K1 disagrees with its plain version at "
                             f"{label}: |err| - {rtol}|ref| = {excess} > "
                             f"{atol}")
    return err


def check_determinism():
    """Two eager calls and two replays of a captured call give bitwise the
    same output at the AR shape; the captured launch, replayed after
    kv_len changes on the card, computes the new length."""
    import torch
    from msd_tpu_torch.ops import decode_attention as K1
    q, k, v, bias, n = _attn_inputs(1, 32, 32, 1280, 672, torch.bfloat16, 7)
    eager = [K1.decode_attention(q, k, v, bias, n) for _ in range(2)]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = K1.decode_attention(q, k, v, bias, n)
    replays = []
    for _ in range(2):
        graph.replay()
        replays.append(captured.clone())
    torch.cuda.synchronize()
    same = all(torch.equal(x, eager[0]) for x in eager[1:] + replays)
    log(f"[K1] determinism: 2 eager calls and 2 graph replays bitwise "
        f"equal: {same}")
    if not same:
        raise AssertionError("K1 is not bitwise deterministic")
    n.fill_(5)
    graph.replay()
    torch.cuda.synchronize()
    ref = K1.decode_attention_reference(q, k, v, bias, 5)
    err = (captured.float() - ref.float()).abs()
    atol, rtol = TOL["bfloat16"]
    log(f"[K1] graph replayed at kv_len 5: max_abs_err "
        f"{err.max().item():.3e}")
    if not (err <= atol + rtol * ref.float().abs()).all():
        raise AssertionError("K1's graph replayed at kv_len 5 disagrees "
                             "with its plain version")


def phase_kernels(card: str) -> dict:
    """K1 against its plain version at the main path's shapes and at the
    edges of its split grid; the determinism gate; then K1, the plain
    version and SDPA timed at the AR shape at four kv_len, and K1's fixed
    cost at kv_len 0."""
    import torch
    import torch.nn.functional as F
    from msd_tpu_torch.ops import decode_attention as K1

    bf16 = torch.bfloat16
    n_split = K1.launch_shape(1, 32, 32, K1.sm_count(0))[2]
    log(f"[K1] grid at the AR shape: {n_split} splits x 32 kv heads on "
        f"{K1.sm_count(0)} SMs")
    # (T, Hq, Hkv, S, kv_len, dtype): S = 1280 is the engine's target KV
    # allocation for max_seq_len 1152 (+ one 48-node tree, rounded up to
    # 128); kv_len 640..702 is what 64 AR tokens after the 639-row prompt
    # give; S = 1152 / kv_len 895 are bench's 256-token run
    cases = [(1, 32, 32, 1280, 640, bf16), (1, 32, 32, 1280, 702, bf16),
             (1, 32, 32, 1152, 640, bf16), (1, 32, 32, 1152, 895, bf16),
             (48, 32, 32, 1280, 750, bf16),   # verify-shaped call
             (1, 32, 8, 1280, 700, bf16),     # GQA
             (1, 32, 32, 1280, 1, bf16),      # one live key
             (5, 32, 32, 1152, 1000, torch.float32)]
    # the split grid's edges: one key per split and either side of it,
    # the longest caches, and the GQA AR row (G*T = 4 in one block)
    cases += [(1, 32, 32, 1280, n, bf16)
              for n in (n_split - 1, n_split, n_split + 1, 1279, 1280)]
    cases += [(1, 32, 8, 1280, K1.launch_shape(1, 32, 8, K1.sm_count(0))[2]
               + 1, bf16)]
    max_err = 0.0
    for i, (t, hq, hkv, s, kv_len, dtype) in enumerate(cases):
        q, k, v, bias, n = _attn_inputs(t, hq, hkv, s, kv_len, dtype, i)
        label = (f"T={t} Hq={hq} Hkv={hkv} S={s} kv_len={kv_len} "
                 f"{str(dtype)[6:]}")
        max_err = max(max_err, check_k1(label, q, k, v, bias, n, kv_len))
    check_determinism()

    # timing at the AR shape over 32 layer caches, cold in L2
    t, hq, hkv, s, layers = 1, 32, 32, 1280, 32
    g = torch.Generator(device="cuda").manual_seed(99)
    q = torch.randn(t, hq, 128, generator=g, device="cuda").to(bf16)
    ks = torch.randn(layers, s, hkv, 128, generator=g, device="cuda").to(bf16)
    vs = torch.randn(layers, s, hkv, 128, generator=g, device="cuda").to(bf16)
    bias = torch.zeros(t, s, device="cuda")
    # kv_len 0 reads no K/V: what is left is the kernel's fixed cost
    n = torch.tensor(0, dtype=torch.int32, device="cuda")
    fixed = [graph_ms(lambda i: K1.decode_attention(
        q, ks[i % layers], vs[i % layers], bias, n), layers) for _ in "ab"]
    log(f"[K1] AR shape kv_len=0 (no K/V read: fixed cost) on {card}: "
        f"kernel {fixed[0] * 1e3:.2f}/{fixed[1] * 1e3:.2f} us")
    by_len = {"0": min(fixed)}
    for kv_len in (640, 672, 895, 1279):
        n = torch.tensor(kv_len, dtype=torch.int32, device="cuda")
        mask = bias[:, :kv_len].to(bf16)[None, None]

        def kernel(i, n=n):
            K1.decode_attention(q, ks[i % layers], vs[i % layers], bias, n)

        def plain(i):
            K1.decode_attention_reference(q, ks[i % layers],
                                          vs[i % layers], bias, kv_len)

        def library(i):
            kk = ks[i % layers, :kv_len].permute(1, 0, 2)[None]
            vv = vs[i % layers, :kv_len].permute(1, 0, 2)[None]
            F.scaled_dot_product_attention(q.permute(1, 0, 2)[None], kk, vv,
                                           attn_mask=mask)

        runs = [("kernel", kernel), ("library", library),
                ("kernel2", kernel)]
        if kv_len == 672:
            runs = [("plain", plain)] + runs + [("plain2", plain)]
        timed = {name: graph_ms(fn, layers) for name, fn in runs}
        ms = min(timed["kernel"], timed["kernel2"])
        nbytes = 2 * t * hq * 128 * 2 + 2 * kv_len * hkv * 128 * 2 \
            + t * kv_len * 4
        ops = 4 * t * hq * kv_len * 128
        bound_s = max(nbytes / HBM_BYTES_PER_S, ops / BF16_OPS_PER_S)
        bound_by = "bytes" if nbytes / HBM_BYTES_PER_S >= \
            ops / BF16_OPS_PER_S else "operations"
        log(f"[K1] AR shape T=1 Hq=Hkv=32 S={s} kv_len={kv_len} bf16 on "
            f"{card}: kernel {timed['kernel'] * 1e3:.2f}/"
            f"{timed['kernel2'] * 1e3:.2f} us, sdpa "
            f"{timed['library'] * 1e3:.2f} us, bound {bound_s * 1e6:.2f} us "
            f"({nbytes / 1e6:.2f} MB by {bound_by}), "
            f"share of bound {bound_s * 1e3 / ms:.3f}"
            + (f", plain {timed['plain'] * 1e3:.2f}/"
               f"{timed['plain2'] * 1e3:.2f} us" if "plain" in timed else ""))
        by_len[str(kv_len)] = ms
        if kv_len == 672:
            entry = {"name": "decode_attention", "route": "cuda",
                     "source": "msd_tpu_torch/csrc/decode_attention.cu",
                     "replaces": "msd_tpu/ops/pallas/decode_attention.py:138",
                     "launches": None, "max_abs_err": max_err, "ms": ms,
                     "plain_ms": min(timed["plain"], timed["plain2"]),
                     "bound_ms": bound_s * 1e3, "bound_by": bound_by,
                     "library_ms": timed["library"]}
            profiled = kernel
    entry["ms_by_kv_len"] = by_len

    def profile():
        # one kernel per call: 32 calls show one kernel name, 32 launches
        prof = device_profile(lambda: [profiled(i) for i in range(layers)],
                              f"K1 x{layers} at the AR shape, kv_len 672")
        if [n for _, n in prof["kernels"]] != [layers]:
            raise AssertionError(f"K1 x{layers} ran kernels "
                                 f"{prof['kernels']}, want one kernel "
                                 f"launched {layers} times")

    # profiled last: a profiler session can slow later host dispatch
    return entry, profile


@contextlib.contextmanager
def oracle_draft(ref, e0: int):
    """Within the block, every verify step sees a tree whose rank-0 chain
    carries the reference continuation: the node at depth d of the tree
    rooted at committed length E proposes ref[E - e0 + d] (where that is
    known), the other nodes keep the draft's proposals. With the canonical
    greedy tokens as reference, each step accepts the whole known chain,
    so the commit's multi-row KV gather, the deep rows of the verify window
    and the suffix staging all run at full depth.

    ``ref`` is an int32 buffer on the device that the step reads, so a
    graph captured in the block reads what it holds at each replay. A graph
    captured outside the block ignores the block: run its requests on a
    generator of their own, which captures inside it."""
    import torch
    from msd_tpu_torch.engine import spec_engine as SE
    verify = SE._verify

    def oracle_verify(st, params, s, tr, cos_t, sin_t):
        rank = SE._medusa_layout(st.tree, st.dcfg.medusa_heads,
                                 str(tr.tokens.device))[8]
        idx = (s.cur_len - e0 + tr.positions).long()
        chain = tr.valid & (rank == 0) & (tr.positions > 0) \
            & (idx < len(ref))
        tr.tokens.copy_(torch.where(
            chain, ref[idx.clamp(0, len(ref) - 1)], tr.tokens))
        return verify(st, params, s, tr, cos_t, sin_t)

    SE._verify = oracle_verify
    try:
        yield
    finally:
        SE._verify = verify


def oracle_schedule(depth: int, max_new: int):
    """(steps, tokens-per-step histogram) of a decode whose every step
    accepts the whole known reference chain: min(depth, tokens still
    known past the root) draft tokens plus the bonus token."""
    hist = np.zeros(16, np.int64)
    done = steps = 0
    while done < max_new:
        n = min(depth, max_new - 1 - done) + 1
        hist[min(n, 15)] += 1
        done, steps = done + n, steps + 1
    return steps, hist


def run_main_path(tcfg, widths, max_seq, max_new, n_img, prompt_tokens,
                  device="cuda", dtype=None, max_new_warm=4):
    """The port's main path through its public entry points, graph-replayed
    (the main path) and eager (``cuda_graphs=False``, for comparison), on
    one set of weights. Returns a dict of tokens, stats and timings; raises
    if graph and eager tokens differ, if MSD departs from the null-draft
    canonical AR, if a graph run replayed a graph captured for other
    weights or captured one inside a timed window, or if the launch-count
    contract fails."""
    import torch
    from msd_tpu_torch.configs import (IMAGE_TOKEN_INDEX, DraftConfig,
                                       EngineConfig, TreeConfig)
    from msd_tpu_torch.engine.generator import MSDGenerator
    from msd_tpu_torch.models import draft as D
    from msd_tpu_torch.models import llama as L
    from msd_tpu_torch.ops import decode_attention as K1
    from msd_tpu_torch.ops.sampling import SamplingParams

    dtype = dtype or torch.bfloat16
    on_card = str(device).startswith("cuda")
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    t0 = time.perf_counter()
    dcfg = DraftConfig(text=tcfg, medusa_heads=len(widths) - 1)
    gen_t = torch.Generator(device=device).manual_seed(0)
    tp = L.init_llama_params(tcfg, gen_t, device, dtype)
    tp["lm_head"].mul_(HEAD_SHARPEN)   # argmax-invariant, widens logit gaps

    def medusa_draft(seed):
        g = torch.Generator(device=device).manual_seed(seed)
        dp = D.init_draft_params(dcfg, g, device, dtype)
        dp["medusa"] = D.init_medusa_params(dcfg, g, device, dtype)
        dp["embed_tokens"] = tp["embed_tokens"]   # the draft shares it
        return dp

    drafts = {"msd": medusa_draft(1), "null": medusa_draft(1234)}
    sync()
    log(f"[main] weights initialised on {device} in "
        f"{time.perf_counter() - t0:.1f}s "
        f"({sum(x.numel() for x in tp['layers'].values()) / 1e9:.2f}G "
        f"layer params)")

    tree = TreeConfig(top_k=widths[0], max_depth=len(widths),
                      num_nodes=1 + sum(widths), medusa_widths=tuple(widths))
    eng = EngineConfig(max_seq_len=max_seq, prompt_pad_multiple=128,
                       tree=tree)

    def generator(cuda_graphs):
        return MSDGenerator(tp, drafts["msd"], tcfg, dcfg, eng, n_img=n_img,
                            eos_id=-1,
                            sp=SamplingParams(greedy_round_bits=ROUND_BITS),
                            device=device, cuda_graphs=cuda_graphs)

    # "graph" is the main path; "eager" runs the same in-place steps
    # without graphs; "oracle" captures its own graphs inside the oracle
    # block
    gens = {"graph": generator(True), "eager": generator(False),
            "oracle": generator(True)}

    def captures(gen):
        return (0, 0.0) if gen.graphs is None else \
            (len(gen.graphs.steps), gen.graphs.capture_seconds)

    # bench's prompt stream: prompt 0, its image rows, then prompt 1
    rng = np.random.default_rng(0)
    vocab_hi = min(31000, tcfg.vocab_size - 1)
    ids0 = rng.integers(3, vocab_hi, size=prompt_tokens).astype(np.int32)
    ids0[1] = IMAGE_TOKEN_INDEX
    feats = torch.from_numpy(rng.normal(size=(n_img, tcfg.hidden_size))
                             * 0.02).to(device=device, dtype=dtype)
    ids1 = rng.integers(3, vocab_hi, size=prompt_tokens).astype(np.int32)
    ids1[1] = IMAGE_TOKEN_INDEX
    prompts = [ids0, ids1]
    n_layers = tcfg.num_hidden_layers

    res = {"times": {}, "peak": {}}
    for mode in ("graph", "eager"):
        gen = gens[mode]
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated() if on_card else 0
        # warm-up outside the timed and counted window: cuBLAS handles,
        # the allocator and, with graphs, one capture per step program
        # and draft (max_new rides in the state, so the timed runs' limit
        # needs no capture of its own)
        gen.naive_generate(ids0, feats, max_new_warm, share_prefill=True)
        for name in ("null", "msd"):
            gen.params["draft"] = drafts[name]
            gen.generate(ids0, feats, max_new_warm)
        sync()
        n_cap, cap_s = captures(gen)
        if mode == "graph":
            log(f"[graphs] {n_cap} captures in {cap_s:.2f}s (warm-up "
                f"included; AR token, verify step with the random draft, "
                f"verify step with the null draft), none in a timed "
                f"window")
        # the main path's counts: zeroed just before, read just after
        K1.decode_attention.launches = 0
        t_main = time.perf_counter()
        for ids in prompts:
            for name in ("ar", "msd", "null"):
                gen.params["draft"] = drafts["msd" if name == "ar" else name]
                t1 = time.perf_counter()
                r = gen.naive_generate(ids, feats, max_new,
                                       share_prefill=True) \
                    if name == "ar" else gen.generate(ids, feats, max_new)
                sync()
                res["times"].setdefault((mode, name), []).append(
                    time.perf_counter() - t1)
                res.setdefault((mode, name), []).append(r)
                if gen.graphs is not None and not gen.graphs.reads(
                        r.graph, gen.params):
                    raise AssertionError(f"{mode} {name}: replayed a graph "
                                         f"captured for other weights")
        gen.params["draft"] = drafts["msd"]
        launches = K1.decode_attention.launches
        res[mode + "_s"] = time.perf_counter() - t_main
        if captures(gen)[0] != n_cap:
            raise AssertionError(f"{mode}: {captures(gen)[0] - n_cap} "
                                 f"captures inside the timed window")
        if on_card:
            res["peak"][mode] = (torch.cuda.max_memory_allocated(),
                                 torch.cuda.max_memory_reserved(), base)
        # the AR loop decodes all but the first token, which the shared
        # prefill samples; every AR row of every layer goes to the kernel
        # on the card (under replay: the calls each graph holds x its
        # replays); CPU tensors take the plain twin, which counts none
        ar_decoded = sum(len(r.tokens) - 1 for r in res[mode, "ar"])
        expected = n_layers * ar_decoded if on_card else 0
        log(f"[main] {mode}: K1 launches {launches}, expected {expected} "
            f"(= {n_layers} layers x {ar_decoded} AR tokens decoded)")
        if launches != expected:
            raise AssertionError(f"{mode}: K1 launch count {launches} != "
                                 f"{expected}")
        if mode == "graph":
            res["launches"], res["ar_decoded"] = launches, ar_decoded
            graphs = {name: {r.graph for r in res[mode, name]}
                      for name in ("ar", "msd", "null")}
            log(f"[graphs] capture replayed per run: {graphs}")
            if gen.graphs is not None and (
                    any(len(g) != 1 for g in graphs.values())
                    or len(set.union(*graphs.values())) != 3):
                raise AssertionError(f"each of AR, MSD and null-draft MSD "
                                     f"must replay one graph of its own: "
                                     f"{graphs}")

    for pi in range(len(prompts)):
        toks = {key: np.asarray(res[key][pi].tokens)
                for key in res if isinstance(key, tuple)}
        for key, tok in toks.items():
            if tok.shape != (max_new,) or tok.min() < 0 \
                    or tok.max() >= tcfg.vocab_size:
                raise AssertionError(f"{key} prompt {pi}: bad tokens "
                                     f"{tok.shape} {tok[:8]}")
        m, a = toks["graph", "msd"], toks["graph", "ar"]
        agree = int(np.argmax(a != m)) if (a != m).any() else len(a)
        same = {f"{k1[0]} {k1[1]} == {k2[0]} {k2[1]}":
                np.array_equal(toks[k1], toks[k2])
                for k1, k2 in ((("graph", "msd"), ("eager", "msd")),
                               (("graph", "msd"), ("graph", "null")),
                               (("graph", "null"), ("eager", "null")),
                               (("graph", "ar"), ("eager", "ar")))}
        log(f"[main] prompt {pi}: " + "; ".join(
            f"{k}: {v}" for k, v in same.items())
            + f"; fast-AR agrees with MSD for the first {agree}/{len(a)} "
            f"tokens")
        if not all(same.values()):
            raise AssertionError(f"prompt {pi}: tokens differ: {same}")

    # deep acceptance: random drafts are almost never accepted, so MSD ran
    # one token per step above; an oracle tree holding the null-draft
    # tokens must be accepted to full depth and still commit those tokens.
    # Its generator captures its verify step inside the block, in an
    # untimed warm-up request; ref is a device buffer refilled per prompt
    gen = gens["oracle"]
    e0 = prompt_tokens + n_img - 1
    steps_want, hist_want = oracle_schedule(len(widths), max_new)
    ref = torch.zeros(max_new, dtype=torch.int32, device=device)
    with oracle_draft(ref, e0):
        ref.copy_(torch.from_numpy(res["graph", "null"][0].tokens))
        gen.generate(ids0, feats, max_new_warm)
        n_cap = captures(gen)[0]
        for pi, ids in enumerate(prompts):
            want = res["graph", "null"][pi].tokens
            ref.copy_(torch.from_numpy(want))
            t1 = time.perf_counter()
            r = gen.generate(ids, feats, max_new)
            sync()
            secs = time.perf_counter() - t1
            hist = r.alpha_hist
            log(f"[main] prompt {pi}: oracle draft (graph {r.graph}) == "
                f"null-draft canonical AR: {np.array_equal(r.tokens, want)}"
                f"; alpha {r.avg_accept_len:.3f} over {r.accept_steps} "
                f"steps (full acceptance: {max_new / steps_want:.3f} over "
                f"{steps_want}), tokens per step "
                f"{dict((i, int(n)) for i, n in enumerate(hist) if n)}, "
                f"{secs * 1e3 / max(r.accept_steps, 1):.2f} ms/step incl. "
                f"prefill")
            if not np.array_equal(r.tokens, want):
                raise AssertionError(f"prompt {pi}: oracle-draft MSD tokens "
                                     f"differ from the null-draft tokens")
            full = min(len(widths) + 1, 15)
            if r.accept_steps != steps_want or \
                    hist[full] != hist_want[full]:
                raise AssertionError(
                    f"prompt {pi}: the oracle tree was not accepted to "
                    f"full depth: {r.accept_steps} steps, "
                    f"{int(hist[full])} of depth {len(widths)} (want "
                    f"{steps_want}, {int(hist_want[full])})")
        if captures(gen)[0] != n_cap:
            raise AssertionError("oracle: a capture inside the timed runs")

    for mode in ("graph", "eager"):
        for name in ("ar", "msd", "null"):
            secs = sum(res["times"][mode, name])
            toks = sum(len(r.tokens) for r in res[mode, name])
            line = f"[main] {mode} {name}: {secs * 1e3 / toks:.2f} " \
                   f"ms/token ({toks} tokens, {secs:.2f}s incl. prefill)"
            if name != "ar":
                steps = sum(r.accept_steps for r in res[mode, name])
                acc = sum(r.accept_len_sum for r in res[mode, name])
                line += f", alpha {acc / max(steps, 1):.3f}, " \
                        f"{secs * 1e3 / max(steps, 1):.2f} ms/step"
            log(line)
        if mode in res["peak"]:
            peak, reserved, base = res["peak"][mode]
            log(f"[main] {mode}: peak device memory {peak / 2**30:.2f} GiB "
                f"allocated ({base / 2**30:.2f} GiB before the warm-up: "
                f"weights and every generator's buffers), "
                f"{reserved / 2**30:.2f} GiB reserved")

    def profile():
        """Where the time goes, profiled after every timed run: one short
        AR and one short MSD request, graph-replayed and eager. In the
        graph AR request the profiler must count the K1 launches that the
        wrapper's count claims: 32 per AR token decoded."""
        out = {}
        for mode in ("graph", "eager"):
            gen = gens[mode]
            prof = device_profile(
                lambda: out.setdefault((mode, "ar"), gen.naive_generate(
                    ids0, feats, 16, share_prefill=True)),
                f"{mode} AR, prefill + 16 tokens", top=10)
            claimed = prof["k1_counted"]
            seen = sum(n for name, n in prof["kernels"]
                       if "decode_kernel" in name)
            k1_us = sum(us for name, us in prof["kernel_us"].items()
                        if "decode_kernel" in name)
            decoded = len(out[mode, "ar"].tokens) - 1
            log(f"[profile] {mode} AR: K1 device launches {seen}, counted "
                f"{claimed}, want {n_layers} x {decoded}; K1 "
                f"{k1_us / 1e3:.3f} ms = "
                f"{k1_us / prof.get('decode_busy_us', float('nan')):.3f} "
                f"of the decode's device time")
            if not seen == claimed == n_layers * decoded:
                raise AssertionError(f"{mode} AR profile: K1 device "
                                     f"launches {seen}, counted {claimed}, "
                                     f"want {n_layers * decoded}")
            prof = device_profile(
                lambda: out.setdefault((mode, "msd"), gen.generate(
                    ids0, feats, 16)),
                f"{mode} MSD, prefill + 16 tokens", top=10)
            out[mode, "step_us"] = prof.get("decode_busy_us", float(
                "nan")) / out[mode, "msd"].accept_steps
        time_verify_attention(out["graph", "step_us"])
        time_replays()

    def time_verify_attention(step_us):
        """Device time of the verify step's attention: the 32
        ``windowed_attention`` calls of one eager step, recorded with their
        inputs and replayed in a CUDA graph, and of them the fp32 widening
        of each layer's whole K and V cache; beside the replayed step's
        device time from the profile."""
        from msd_tpu_torch.models import llama as Lm
        real, calls = Lm.windowed_attention, []

        def record(*args, **kwargs):
            calls.append((args, kwargs))
            return real(*args, **kwargs)

        Lm.windowed_attention = record
        try:
            gens["eager"].generate(ids0, feats, 2)
        finally:
            Lm.windowed_attention = real
        calls = calls[:n_layers]
        attn = graph_ms(lambda i: real(*calls[i][0], **calls[i][1]),
                        n_layers) * n_layers
        widen = graph_ms(lambda i: (calls[i][0][1].float(),
                                    calls[i][0][2].float()),
                         n_layers) * n_layers
        q, k = calls[0][0][0], calls[0][0][1]
        log(f"[verify attention] windowed_attention at the verify shape "
            f"(q {tuple(q.shape)}, K/V {tuple(k.shape)} {k.dtype}), "
            f"{n_layers} layers of one step: {attn:.3f} ms (graph replay), "
            f"of which the fp32 widening of K and V {widen:.3f} ms; "
            f"replayed step's device time {step_us / 1e3:.3f} ms: "
            f"attention {attn * 1e3 / step_us:.3f}, widening "
            f"{widen * 1e3 / step_us:.3f} of it")

    def time_replays(n=16):
        """Where the replayed decode's idle time lies: n replays of the AR
        token and of the verify step, from a live request's state, each
        followed by the loop's host read of ``done``, then back to back
        with one synchronise at the end; host wall and the time between
        CUDA events around the n replays, per replay. Back to back, the
        event time less the step's kernel time (profile) is the gaps
        between the graph's kernels; the per-replay read adds the host
        round trip."""
        gen = gens["graph"]
        for name, request in (
                ("AR token", lambda: gen.naive_generate(
                    ids0, feats, 2, share_prefill=True)),
                ("verify step", lambda: gen.generate(ids0, feats, 2))):
            parts = []
            for read in (True, False):
                step = gen.graphs.steps[request().graph]
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                start.record()
                for _ in range(n):
                    step()
                    if read:
                        bool(gen.state.done)
                end.record()
                end.synchronize()
                wall = (time.perf_counter() - t1) * 1e3 / n
                how = "with a read of done" if read else "back to back"
                parts.append(f"{how} {wall:.3f} ms wall, "
                             f"{start.elapsed_time(end) / n:.3f} ms events")
            log(f"[graphs] {n} replays of the {name}, per replay: "
                + "; ".join(parts))

    res["profile"] = profile
    # what the later phases drive: the same weights, generators and prompts
    res["ctx"] = {"gens": gens, "drafts": drafts, "prompts": prompts,
                  "feats": feats, "tcfg": tcfg, "widths": widths,
                  "max_new": max_new, "max_new_warm": max_new_warm,
                  "device": device, "sync": sync, "on_card": on_card,
                  "e0": e0, "captures": captures,
                  "null": [r.tokens for r in res["graph", "null"]]}
    return res


def bench_fit(rows, vocab: int, device, label: str):
    """bench.py's fit (bench.py:1237-1248) on the valid nodes of collecting
    runs (``rows``: one dict of per-node fields per run): the calibrated
    tables on ``device``."""
    from msd_tpu_torch.calib.device import CalibTables
    from msd_tpu_torch.calib.grouped import (GroupedIsotonicCalibrator,
                                             soft_labels_from)
    t1 = time.perf_counter()
    data = {k: np.concatenate([r[k] for r in rows]) for k in rows[0]}
    soft = soft_labels_from(data["base_conf"].astype(np.float64),
                            np.maximum(data["draft_conf"].astype(
                                np.float64), 1e-6))
    fit_feats = {"token_category": np.asarray(["content"] * len(soft)),
                 "avg_visual_attention_intensity": data["attn"],
                 "tree_depth": data["depth"].astype(float),
                 "draft_margin": data["margin"],
                 "draft_confidence": data["draft_conf"]}
    cal = GroupedIsotonicCalibrator(min_samples_per_group=200,
                                    max_grouping_level=2, target="soft")
    cal.fit(fit_feats, soft, data["base_top1"].astype(float))
    fitted = CalibTables.from_host(cal.export_tables(),
                                   np.zeros(vocab, np.int8), device=device)
    log(f"{label} fit on {len(soft)} samples (min_samples_per_group 200, "
        f"max_grouping_level 2, soft target): "
        f"{time.perf_counter() - t1:.2f}s; groups fitted at level 1/2: "
        f"{sum(v is not None for v in cal.levels[1].values())}/"
        f"{sum(v is not None for v in cal.levels[2].values())}")
    return fitted


def _calib_sanity(cd: dict, steps: int, nodes: int, label: str):
    """A collecting run's features: one row per verify step, every
    non-root node of the tree valid, confidences in [0, 1], finite
    features, accepted nodes among the valid ones (the root aside)."""
    valid = cd["valid"].astype(bool)
    bad = []
    if any(v.shape != (steps, nodes) for v in cd.values()):
        bad.append(f"shapes {[v.shape for v in cd.values()]}")
    if valid.sum() != steps * (nodes - 1):
        bad.append(f"{valid.sum()} valid samples, want {steps * (nodes - 1)}")
    conf = cd["draft_conf"][valid]
    if not ((conf >= 0) & (conf <= 1)).all():
        bad.append("draft_conf outside [0, 1]")
    if not all(np.isfinite(cd[k]).all() for k in
               ("attn", "margin", "base_conf", "base_margin")):
        bad.append("a feature is not finite")
    if (cd["accept"][:, 1:].astype(bool) & ~valid[:, 1:]).any():
        bad.append("an accepted node is not valid")
    if not (cd["depth"][valid] >= 1).all():
        bad.append("a valid node at depth 0")
    log(f"[calib] {label}: {steps} steps, {int(valid.sum())} samples, "
        f"draft_conf {conf.min():.3e}..{conf.max():.3e}, attn "
        f"{cd['attn'][valid].min():.3e}..{cd['attn'][valid].max():.3e}, "
        f"accepted nodes {int(cd['accept'][:, 1:].sum())}: "
        f"{'ok' if not bad else bad}")
    if bad:
        raise AssertionError(f"{label}: calibration features: {bad}")


def run_calib(res) -> dict:
    """The calibrated tree rerank on the main path's weights and prompts
    (graph-replayed unless stated): a collecting run per prompt and its
    features; a fit with bench.py's settings; calibrated MSD with the
    fitted tables, graph and eager; a "demote" calibrator that must change
    the trees; the swap back to the fitted tables replaying their graph;
    the calibrated oracle draft, accepted to full depth; ms/step and peak
    memory. Every run must commit the null-draft tokens and replay a graph
    that reads its own tables."""
    import torch
    from msd_tpu_torch.calib.device import CalibTables
    from msd_tpu_torch.calib.token_class import synthetic_vocab_table
    from msd_tpu_torch.ops import decode_attention as K1

    c = res["ctx"]
    gens, prompts, feats, null = c["gens"], c["prompts"], c["feats"], \
        c["null"]
    max_new, warm, sync = c["max_new"], c["max_new_warm"], c["sync"]
    nodes = 1 + sum(c["widths"])
    out = {"times": {}}
    for gen in gens.values():
        gen.params["draft"] = c["drafts"]["msd"]

    def timed(key, fn):
        sync()
        t1 = time.perf_counter()
        r = fn()
        sync()
        out["times"].setdefault(key, []).append(
            (time.perf_counter() - t1, r.accept_steps))
        return r

    def check(label, r, pi, gen):
        if not np.array_equal(r.tokens, null[pi]):
            raise AssertionError(f"{label} prompt {pi}: tokens differ from "
                                 f"the null-draft tokens")
        if gen.graphs is not None and not gen.graphs.reads(r.graph,
                                                           gen.params):
            raise AssertionError(f"{label} prompt {pi}: replayed a graph "
                                 f"that reads other weights or tables")

    t0 = time.perf_counter()
    graph, eager = gens["graph"], gens["eager"]
    graph.generate(prompts[0], feats, warm, collect_calibration=True)
    K1.decode_attention.launches = 0
    n_cap = c["captures"](graph)[0]
    rows, plain = [], []
    for pi, ids in enumerate(prompts):
        r = timed("collecting", lambda: graph.generate(
            ids, feats, max_new, collect_calibration=True))
        check("collecting", r, pi, graph)
        _calib_sanity(r.calib_data, r.accept_steps, nodes,
                      f"collecting prompt {pi} (graph {r.graph})")
        valid = r.calib_data["valid"].astype(bool)
        rows.append({k: v[valid] for k, v in r.calib_data.items()})
        plain.append(r.calib_data)

    vocab = c["tcfg"].vocab_size
    fitted = bench_fit(rows, vocab, c["device"], "[calib]")

    # the fitted tables, graph and eager
    got = {}
    for mode, gen in (("graph", graph), ("eager", eager)):
        gen.set_calibrator(fitted)
        if mode == "graph":
            gen.generate(prompts[0], feats, warm, use_calibration=True)
        for pi, ids in enumerate(prompts):
            r = timed(f"{mode} calibrated", lambda: gen.generate(
                ids, feats, max_new, use_calibration=True))
            check(f"{mode} calibrated", r, pi, gen)
            got[mode, pi] = r
    for pi in range(len(prompts)):
        a, b = got["graph", pi], got["eager", pi]
        same = np.array_equal(a.tokens, b.tokens) and \
            (a.accept_steps, a.accept_len_sum) == \
            (b.accept_steps, b.accept_len_sum)
        log(f"[calib] prompt {pi}: calibrated graph {a.graph} == eager "
            f"(tokens, steps, acc_sum): {same}; == null-draft tokens: True; "
            f"alpha {a.avg_accept_len:.3f}")
        if not same:
            raise AssertionError(f"calibrated prompt {pi}: graph and eager "
                                 f"differ")

    # a calibrator that demotes one token class: the trees must change
    table = np.full((3, 5, 2, 3, 8), 0.5, np.float32)
    table[2] = 1e-3
    demote = CalibTables.from_host(
        {"table": table, "attn_quantiles": [.2, .4, .6, .8],
         "margin_quantiles": [.33, .67], "global_mean": 0.5},
        synthetic_vocab_table(vocab, 0), base_alpha=10.0,
        device=c["device"])
    graph.set_calibrator(demote)
    graph.generate(prompts[0], feats, warm, use_calibration=True,
                   collect_calibration=True)
    for pi, ids in enumerate(prompts):
        r = timed("demote", lambda: graph.generate(
            ids, feats, max_new, use_calibration=True,
            collect_calibration=True))
        check("demote", r, pi, graph)
        n = min(r.accept_steps, plain[pi]["token"].shape[0])
        changed = int((r.calib_data["token"][:n]
                       != plain[pi]["token"][:n]).any(axis=1).sum())
        log(f"[calib] prompt {pi}: demote calibrator (graph {r.graph}): "
            f"trees differ from the uncalibrated ones in {changed} of {n} "
            f"steps; == null-draft tokens: True")
        if changed == 0:
            raise AssertionError(f"prompt {pi}: the demote calibrator left "
                                 f"every tree unchanged")
    graph.set_calibrator(fitted)
    back = graph.generate(prompts[0], feats, max_new, use_calibration=True)
    check("fitted again", back, 0, graph)
    log(f"[calib] fitted tables again: replays graph {back.graph} (first "
        f"fitted run: {got['graph', 0].graph})")
    if back.graph != got["graph", 0].graph:
        raise AssertionError("the fitted tables did not replay their graph")
    # two captures, each in an untimed warm-up: fitted, demote
    if graph.graphs is not None and c["captures"](graph)[0] != n_cap + 2:
        raise AssertionError("calib: a capture inside a timed window")
    launches = K1.decode_attention.launches
    log(f"[calib] K1 launches in the calibrated MSD runs: {launches} "
        f"(verify attention does not use K1)")

    # the calibrated oracle draft: the rerank, then the deep commit
    oracle = gens["oracle"]
    oracle.set_calibrator(fitted)
    steps_want, hist_want = oracle_schedule(len(c["widths"]), max_new)
    full = min(len(c["widths"]) + 1, 15)
    ref = torch.zeros(max_new, dtype=torch.int32, device=c["device"])
    with oracle_draft(ref, c["e0"]):
        ref.copy_(torch.from_numpy(null[0]))
        oracle.generate(prompts[0], feats, warm, use_calibration=True)
        for pi, ids in enumerate(prompts):
            ref.copy_(torch.from_numpy(null[pi]))
            r = oracle.generate(ids, feats, max_new, use_calibration=True)
            check("calibrated oracle", r, pi, oracle)
            log(f"[calib] prompt {pi}: calibrated oracle draft (graph "
                f"{r.graph}): alpha {r.avg_accept_len:.3f} over "
                f"{r.accept_steps} steps (full acceptance: "
                f"{max_new / steps_want:.3f} over {steps_want})")
            if r.accept_steps != steps_want or \
                    r.alpha_hist[full] != hist_want[full]:
                raise AssertionError(f"prompt {pi}: the calibrated oracle "
                                     f"tree was not accepted to full depth")

    # ms/step, and peak memory of one uncalibrated and one calibrated
    # request on the graph generator
    for key, runs in out["times"].items():
        secs = sum(t for t, _ in runs)
        steps = sum(n for _, n in runs)
        log(f"[calib] {key}: {secs * 1e3 / max(steps, 1):.2f} ms/step over "
            f"{steps} steps ({secs:.2f}s incl. prefill)")
        out[key] = secs * 1e3 / max(steps, 1)
    if c["on_card"]:
        peaks = {}
        n_cap = c["captures"](graph)[0]
        for name, kw in (("uncalibrated", {}),
                         ("calibrated", {"use_calibration": True})):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            graph.generate(prompts[0], feats, max_new, **kw)
            torch.cuda.synchronize()
            peaks[name] = (torch.cuda.max_memory_allocated() - base) / 2**20
        if c["captures"](graph)[0] != n_cap:
            raise AssertionError("calib: installed tables made a step that "
                                 "does not rerank capture again")
        log(f"[calib] peak device memory above the resident weights and "
            f"buffers, one request: uncalibrated {peaks['uncalibrated']:.1f}"
            f" MiB, calibrated {peaks['calibrated']:.1f} MiB")
    out["seconds"] = time.perf_counter() - t0
    log(f"[calib] phase took {out['seconds']:.1f}s")
    return out


def sampling_tv(device, n: int = 4000) -> float:
    """The distribution test of the speculative-sampling walk: a root with
    three drafted children and one grandchild, a target distribution over
    16 tokens; the first token each walk emits after the root, over n walks
    with draws from a seeded generator on ``device``, against the target's
    conditional at the root. Returns the total variation."""
    import torch
    from msd_tpu_torch.engine import tree as T
    from msd_tpu_torch.ops.sampling import gumbel_noise

    V, N = 16, 5
    dev = torch.device(device)
    tree = T.Tree(
        tokens=torch.tensor([2, 3, 7, 12, 5], dtype=torch.int32, device=dev),
        parents=torch.tensor([0, 0, 0, 0, 1], dtype=torch.int32, device=dev),
        mask=torch.tensor([[1, 0, 0, 0, 0], [1, 1, 0, 0, 0],
                           [1, 0, 1, 0, 0], [1, 0, 0, 1, 0],
                           [1, 1, 0, 0, 1]], dtype=torch.bool, device=dev),
        positions=torch.tensor([0, 1, 1, 1, 2], dtype=torch.int32,
                               device=dev),
        retrieve=torch.tensor([[0, -1, -1], [0, 1, -1], [0, 2, -1],
                               [0, 3, -1], [0, 1, 4]], dtype=torch.int32,
                              device=dev),
        valid=torch.ones(N, dtype=torch.bool, device=dev))
    logits = np.random.default_rng(0).normal(size=(N, V)) * 1.5
    probs = torch.from_numpy((np.exp(logits) / np.exp(logits).sum(
        -1, keepdims=True)).astype(np.float32)).to(dev)
    g = torch.Generator(device=dev).manual_seed(42)
    K = T.sampling_width(N, 10)
    us = torch.rand(n, 2, K, generator=g, device=dev)
    noise = gumbel_noise(torch.rand(n, V, generator=g, device=dev))
    firsts = torch.zeros(n, dtype=torch.long, device=dev)
    for i in range(n):
        best, acc, nxt = T.evaluate_sampling(tree, probs, us[i], noise[i])
        first = tree.tokens[tree.retrieve[best.reshape(1), 1]][0]
        firsts[i] = torch.where(acc >= 1, first, nxt)
    emp = torch.bincount(firsts, minlength=V).double().cpu().numpy() / n
    return 0.5 * float(np.abs(emp - probs[0].double().cpu().numpy()).sum())


def run_sampling(res, seed: int = 17, tv_draws: int = 4000) -> dict:
    """Sampling mode at T=1 (bench.py's --temperature default) on prompt
    0: MSD and the shared-prefill AR baseline, graph-replayed and eager.
    The same seed must give the same tokens under replay and the eager
    tokens of that seed, another seed other tokens; K1's launches must be
    32 per AR token decoded; the walk must keep the target distribution on
    the card (total variation < 0.05 over ``tv_draws`` walks). Returns
    timings; ``profile`` (called last) profiles a sampled verify step and
    times the acceptance walk alone."""
    import torch
    from msd_tpu_torch.engine import spec_engine as SE
    from msd_tpu_torch.ops import decode_attention as K1
    from msd_tpu_torch.ops.sampling import SamplingParams

    c = res["ctx"]
    gens, feats, sync = c["gens"], c["feats"], c["sync"]
    ids, max_new = c["prompts"][0], c["max_new"]
    sp = SamplingParams(temperature=1.0, greedy_round_bits=ROUND_BITS)
    n_layers = c["tcfg"].num_hidden_layers
    t0 = time.perf_counter()
    out = {}

    def msd(gen, s, n=max_new):
        return gen.generate(ids, feats, n, seed=s, sp=sp)

    def ar(gen, s, n=max_new):
        return gen.naive_generate(ids, feats, n, seed=s, sp=sp,
                                  share_prefill=True)

    for gen in gens.values():
        gen.params["draft"] = c["drafts"]["msd"]
    graph, eager = gens["graph"], gens["eager"]
    for run in (msd, ar):
        run(graph, 0, c["max_new_warm"])
    n_cap = c["captures"](graph)[0]
    runs = {}
    K1.decode_attention.launches = 0
    for name, run in (("msd", msd), ("ar", ar)):
        for mode, gen, s in (("graph", graph, seed), ("graph", graph, seed),
                             ("eager", eager, seed),
                             ("graph", graph, seed + 1)):
            sync()
            t1 = time.perf_counter()
            r = run(gen, s)
            sync()
            runs.setdefault((name, mode, s), []).append(
                (r, time.perf_counter() - t1))
    launches = K1.decode_attention.launches
    if c["captures"](graph)[0] != n_cap:
        raise AssertionError("sampling: a capture inside a timed window")
    ar_decoded = sum(len(r.tokens) - 1 for key, rs in runs.items()
                     if key[0] == "ar" for r, _ in rs)
    expected = n_layers * ar_decoded if c["on_card"] else 0
    log(f"[sampling] K1 launches {launches}, expected {expected} (= "
        f"{n_layers} layers x {ar_decoded} sampled AR tokens decoded, "
        f"graph and eager)")
    if launches != expected:
        raise AssertionError(f"sampling: K1 launch count {launches} != "
                             f"{expected}")
    for name in ("msd", "ar"):
        (a, ta), (b, tb) = runs[name, "graph", seed]
        e, te = runs[name, "eager", seed][0]
        o, to = runs[name, "graph", seed + 1][0]
        for r in (a, b, e, o):
            tok = np.asarray(r.tokens)
            if tok.shape != (max_new,) or tok.min() < 0 \
                    or tok.max() >= c["tcfg"].vocab_size:
                raise AssertionError(f"sampled {name}: bad tokens "
                                     f"{tok.shape} {tok[:8]}")
        same = {"replay == replay": np.array_equal(a.tokens, b.tokens)
                and a.accept_len_sum == b.accept_len_sum,
                "graph == eager": np.array_equal(a.tokens, e.tokens)
                and a.accept_len_sum == e.accept_len_sum,
                f"seed {seed + 1} differs": not np.array_equal(a.tokens,
                                                                o.tokens)}
        line = (f"[sampling] T=1 {name}, seed {seed}: "
                + "; ".join(f"{k}: {v}" for k, v in same.items())
                + f"; graph {ta * 1e3 / len(a.tokens):.2f}/"
                f"{tb * 1e3 / len(b.tokens):.2f} ms/token, eager "
                f"{te * 1e3 / len(e.tokens):.2f} ms/token")
        if name == "msd":
            steps = a.accept_steps + b.accept_steps
            line += (f", alpha {a.avg_accept_len:.3f}, graph "
                     f"{(ta + tb) * 1e3 / steps:.2f} ms/step, eager "
                     f"{te * 1e3 / e.accept_steps:.2f} ms/step")
            out["msd_ms_per_step"] = (ta + tb) * 1e3 / steps
            out["alpha"] = a.avg_accept_len
        else:
            out["ar_ms_per_token"] = (ta + tb) * 1e3 / (2 * max_new)
        log(line)
        if not all(same.values()):
            raise AssertionError(f"sampled {name}: {same}")
    t1 = time.perf_counter()
    tv = sampling_tv(c["device"], tv_draws)
    log(f"[sampling] speculative-sampling walk on {c['device']}: total "
        f"variation {tv:.4f} over {tv_draws} walks (limit 0.05), "
        f"{time.perf_counter() - t1:.1f}s")
    if not tv < 0.05:
        raise AssertionError(f"sampling walk: total variation {tv} >= 0.05")
    out["tv"] = tv

    def profile():
        """A profiled sampled request (graph, prefill + 16 tokens) for the
        replayed verify step's device time, and the acceptance walk of one
        of its steps alone: recorded with its inputs from an eager step and
        replayed in a CUDA graph."""
        prof = device_profile(lambda: out.setdefault("prof_run", msd(
            graph, seed, 16)), "graph sampled MSD, prefill + 16 tokens",
            top=8)
        step_us = prof.get("decode_busy_us", float("nan")) / \
            out["prof_run"].accept_steps
        real, calls = SE.tree_mod.evaluate_sampling, []

        def record(*args, **kwargs):
            calls.append((args, kwargs))
            return real(*args, **kwargs)

        SE.tree_mod.evaluate_sampling = record
        try:
            msd(eager, seed, 2)
        finally:
            SE.tree_mod.evaluate_sampling = real
        args, kwargs = calls[0]
        walk_ms = graph_ms(lambda i: real(*args, **kwargs), 1)
        log(f"[sampling] acceptance walk ({args[2].shape[0]} depths x "
            f"{args[2].shape[1]} children over a [{args[1].shape[1]}] "
            f"residual) alone: {walk_ms:.3f} ms (graph replay); replayed "
            f"sampled verify step's device time {step_us / 1e3:.3f} ms: "
            f"walk {walk_ms * 1e3 / step_us:.3f} of it")
        out["walk_ms"], out["step_ms"] = walk_ms, step_us / 1e3

    out["profile"] = profile
    out["seconds"] = time.perf_counter() - t0
    log(f"[sampling] phase took {out['seconds']:.1f}s")
    return out


def distill_schedule(steps: int, rounds: int) -> list:
    """Steps per record -> train round, bench.py's decaying schedule
    (bench.py:923-929): budgets halve, at least 50 a round, the first takes
    the rest."""
    out = [max(50, steps >> (it + 1)) for it in range(rounds)]
    if rounds > 1:
        out[-1] = max(50, out[-2] // 2)
    out[0] += max(0, steps - sum(out))
    return out


def bench_trainer_config(steps: int, lr: float, pad_rec: int):
    """bench.py's trainer settings for one record -> train round of
    ``steps`` steps at ``lr`` over records of ``pad_rec`` rows."""
    from msd_tpu_torch.train.draft_train import TrainConfig
    from msd_tpu_torch.train.trainer import TrainerConfig
    return TrainerConfig(
        train=TrainConfig(lr=lr, warmup_steps=20, total_steps=max(steps, 21),
                          noise_std=0.0, p_w=0.1, noise_rel=0.01, v_norm=True,
                          medusa_w=1.0, rollout_steps=0),
        batch_size=2, max_len=pad_rec, num_epochs=1, log_every=10 ** 9)


def train_step_ops(tcfg, n_med: int, rows: int, batch: int) -> int:
    """Floating-point operations of one ``train_step`` (matmuls only, each
    multiply-add two): per sequence the target's logits, the draft's fc,
    projections, attention and MLP, its logits, the medusa resblocks and
    their logits forward; backward the fc's weight gradient (its input is
    data), twice the rest of the draft (input and weight gradients), the
    input gradient of every logit product, and the recompute of each
    checkpointed medusa head."""
    T, H = rows, tcfg.hidden_size
    kv = tcfg.num_key_value_heads * tcfg.head_dim
    logits = 2 * T * H * tcfg.vocab_size
    fc = 2 * T * 2 * H * H
    body = (2 * 2 * T * H * H + 2 * 2 * T * H * kv
            + 3 * 2 * T * H * tcfg.intermediate_size + 2 * 2 * T * T * H
            + n_med * 2 * T * H * H)
    forward = logits + fc + body + logits + n_med * logits
    backward = fc + 2 * body + logits + 2 * n_med * logits
    return batch * (forward + backward)


def run_distill(res, steps: int = DISTILL_STEPS,
                rounds: int = DISTILL_ROUNDS) -> dict:
    """bench.py's draft distillation (bench.py:750-1000, records from the
    engine) on the main path's target and prompts, on a generator of its
    own, graph-replayed. Each round serves the current draft (timed MSD,
    tokens == null-draft tokens), collects one record per prompt from the
    engine's own hiddens (tokens == the non-collecting run's), trains a
    fresh trainer over fp32 master weights with bench's settings and
    serves the bf16 cast of the result through ``set_draft``. Raises if
    any MSD run departs from the null-draft tokens, if the last round's
    mean loss is not below the first's, or if alpha does not rise above
    the random draft's."""
    import torch
    from msd_tpu_torch.engine.generator import MSDGenerator
    from msd_tpu_torch.ops import decode_attention as K1
    from msd_tpu_torch.train.data_gen import record_from_traj
    from msd_tpu_torch.train.trainer import DraftTrainer, tree_map

    c = res["ctx"]
    t0 = time.perf_counter()
    base = c["gens"]["graph"]
    tp = base.params["target"]
    prompts, feats, null = c["prompts"], c["feats"], c["null"]
    max_new, warm, sync = c["max_new"], c["max_new_warm"], c["sync"]
    on_card, n_img = c["on_card"], base.n_img
    gen = MSDGenerator(tp, c["drafts"]["msd"], base.tcfg, base.dcfg,
                       base.eng, n_img=n_img, eos_id=base.eos_id,
                       sp=base.sp, device=c["device"])
    # bench's record length: prompt, image rows and the whole decode
    pad_rec = ((len(prompts[0]) + n_img - 1 + max_new + 127) // 128) * 128
    emb_host = tp["embed_tokens"].float().cpu().numpy()
    feats_host = feats.float().cpu().numpy()
    out = {"rounds": [], "alpha": []}

    def serve(label):
        """Timed graph-replayed MSD on every prompt, after an untimed
        warm-up that captures; every run must commit the null-draft
        tokens. Returns the runs."""
        gen.generate(prompts[0], feats, warm)
        runs, secs = [], 0.0
        for pi, ids in enumerate(prompts):
            sync()
            t1 = time.perf_counter()
            r = gen.generate(ids, feats, max_new)
            sync()
            secs += time.perf_counter() - t1
            if not np.array_equal(r.tokens, null[pi]):
                raise AssertionError(f"distill {label} prompt {pi}: MSD "
                                     f"tokens differ from the null-draft "
                                     f"tokens")
            if gen.graphs is not None and not gen.graphs.reads(r.graph,
                                                               gen.params):
                raise AssertionError(f"distill {label}: replayed a graph "
                                     f"of another draft")
            runs.append(r)
        steps = sum(r.accept_steps for r in runs)
        alpha = sum(r.accept_len_sum for r in runs) / max(steps, 1)
        toks = sum(len(r.tokens) for r in runs)
        out["alpha"].append(alpha)
        log(f"[distill] {label}: graph MSD alpha {alpha:.3f} over {steps} "
            f"steps, {secs * 1e3 / toks:.2f} ms/token, "
            f"{secs * 1e3 / max(steps, 1):.2f} ms/step ({toks} tokens, "
            f"prefill included); == null-draft tokens: True")
        return runs

    def collect(label, runs):
        """The collecting runs (after an untimed warm-up that captures),
        whose tokens must equal the plain ``runs``'. Returns them and
        their seconds."""
        gen.generate(prompts[0], feats, warm, collect_hiddens=True)
        sync()
        t1 = time.perf_counter()
        got = [gen.generate(ids, feats, max_new, collect_hiddens=True)
               for ids in prompts]
        sync()
        secs = time.perf_counter() - t1
        same = all(np.array_equal(a.tokens, b.tokens)
                   for a, b in zip(got, runs))
        log(f"[distill] {label}: collecting runs {secs:.2f}s for "
            f"{len(got)} records of {[r.traj_hidden.shape for r in got]} "
            f"hiddens; tokens == the non-collecting runs': {same}")
        if not same:
            raise AssertionError("distill: collecting changed the tokens")
        return got, secs

    steps_it = distill_schedule(steps, rounds)
    for it in range(rounds):
        label = "random draft" if it == 0 else f"draft after round {it}"
        got, coll_s = collect(label, serve(label))
        recs = [record_from_traj(r.traj_hidden, r.exp_ids, c["e0"], 1,
                                 n_img, feats_host, emb_host, pad_rec)
                for r in got]
        lr = 1e-3 / 3.0 ** it
        tc = bench_trainer_config(steps_it[it], lr, pad_rec)
        if on_card:
            sync()
            torch.cuda.reset_peak_memory_stats()
            mem0 = torch.cuda.memory_allocated()
        t1 = time.perf_counter()
        trainer = DraftTrainer(gen.dcfg, gen.params["draft"],
                               tp["lm_head"], tc)
        hist = []
        while trainer.step_count < steps_it[it]:
            hist.append(trainer.run_epoch([], recs, log=lambda *a: None))
        sync()
        train_s = time.perf_counter() - t1
        peak = (torch.cuda.max_memory_allocated(), mem0) if on_card \
            else None
        names = ("loss", "vloss", "ploss", "top1_agree", "medusa1_agree")
        mean_loss = float(np.mean([m["loss"] for m in hist]))
        rnd = {"steps": trainer.step_count, "lr": lr, "seconds": train_s,
               "s_per_step": train_s / trainer.step_count,
               "collect_s": coll_s, "mean_loss": mean_loss, "peak": peak,
               "first": {k: hist[0][k] for k in names},
               "last": {k: hist[-1][k] for k in names}}
        out["rounds"].append(rnd)
        log(f"[distill] round {it}: {rnd['steps']} steps at lr {lr:.3e} "
            f"(batch 2 x {pad_rec} rows) in {train_s:.2f}s, "
            f"{rnd['s_per_step']:.4f} s/step (trainer set-up included); "
            f"mean loss {mean_loss:.4f}; first/last " + ", ".join(
                f"{k} {rnd['first'][k]:.4f}/{rnd['last'][k]:.4f}"
                for k in names))
        if peak is not None:
            log(f"[distill] round {it}: peak device memory while training "
                f"{peak[0] / 2**30:.2f} GiB allocated ({peak[1] / 2**30:.2f}"
                f" GiB before: the resident weights and every generator's "
                f"buffers)")
        # rebuild: the bf16 cast of the fp32 master weights, the
        # embedding shared with the target (bench.py:750-775)
        dtype = tp["embed_tokens"].dtype
        trained = {k: tree_map(lambda t: t.detach().to(dtype), v)
                   for k, v in trainer.params.items()
                   if k != "embed_tokens"}
        trained["embed_tokens"] = tp["embed_tokens"]
        del trainer
        gen.set_draft(trained)
    out["last"] = (trained, recs, tc)

    serve(f"draft after round {rounds}")
    first, last = out["rounds"][0]["mean_loss"], out["rounds"][-1][
        "mean_loss"]
    # the AR baseline on the same generator and prompts, through K1
    gen.naive_generate(prompts[0], feats, warm, share_prefill=True)
    K1.decode_attention.launches = 0
    secs = toks = decoded = 0
    for ids in prompts:
        sync()
        t1 = time.perf_counter()
        r = gen.naive_generate(ids, feats, max_new, share_prefill=True)
        sync()
        secs += time.perf_counter() - t1
        toks += len(r.tokens)
        decoded += len(r.tokens) - 1
    launches = K1.decode_attention.launches
    expected = base.tcfg.num_hidden_layers * decoded if on_card else 0
    log(f"[distill] graph AR on the same generator: "
        f"{secs * 1e3 / toks:.2f} ms/token ({toks} tokens, prefill "
        f"included); K1 launches {launches}, expected {expected}")
    if launches != expected:
        raise AssertionError(f"distill: K1 launch count {launches} != "
                             f"{expected}")
    out["seconds"] = time.perf_counter() - t0
    log(f"[distill] alpha {out['alpha'][0]:.3f} (random draft) -> "
        f"{out['alpha'][-1]:.3f} (trained); mean loss of round 0 "
        f"{first:.4f}, of round {rounds - 1} {last:.4f}; collection "
        f"{sum(r['collect_s'] for r in out['rounds']):.2f}s, training "
        f"{sum(r['seconds'] for r in out['rounds']):.2f}s; phase took "
        f"{out['seconds']:.1f}s")
    if not last < first:
        raise AssertionError(f"distill: the last round's mean loss {last} "
                             f"is not below the first's {first}")
    if not out["alpha"][-1] > out["alpha"][0]:
        raise AssertionError(f"distill: alpha {out['alpha'][-1]} after "
                             f"training is not above the random draft's "
                             f"{out['alpha'][0]}")
    del gen

    def profile():
        """One train step of the last round's configuration on the trained
        draft, profiled after an untimed step."""
        trained, recs, tc = out.pop("last")
        trainer = DraftTrainer(base.dcfg, trained, tp["lm_head"], tc)
        trainer.run_epoch([], recs, log=lambda *a: None)
        prof = device_profile(lambda: trainer.run_epoch(
            [], recs, log=lambda *a: None),
            f"train step, batch 2 x {pad_rec} rows, fp32", top=8)
        gemm_us = sum(us for name, us in prof["kernel_us"].items()
                      if "gemm" in name.lower() or name.startswith("nvjet")
                      or "splitk" in name.lower())
        ops = train_step_ops(base.tcfg, base.dcfg.medusa_heads, pad_rec, 2)
        bound_ms = ops / FP32_OPS_PER_S * 1e3
        log(f"[distill] train step: {ops / 1e12:.2f} TFLOP of fp32 matmuls "
            f"(counted from the shapes), bound {bound_ms:.1f} ms at the "
            f"fp32 peak; device {prof['busy_us'] / 1e3:.1f} ms "
            f"({ops / prof['busy_us'] / 1e6:.1f} TFLOP/s, roofline share "
            f"{bound_ms * 1e3 / prof['busy_us']:.3f}), GEMMs "
            f"{gemm_us / prof['busy_us']:.3f} of it")

    out["profile"] = profile
    return out


@contextlib.contextmanager
def stop_depths(buf):
    """Within the block every verify step writes the deepest valid node of
    its tree into ``buf[step]`` on the device: the step's stop depth when
    the budget holds every explored node (num_nodes - 1 >= max_depth x
    top_k). A graph captured in the block holds the write, as with
    ``oracle_draft``; the engine has no counter of its own."""
    import torch
    from msd_tpu_torch.engine import spec_engine as SE
    verify = SE._verify

    def verify_depth(st, params, s, tr, cos_t, sin_t):
        depth = torch.where(tr.valid, tr.positions, 0).max()
        buf.index_copy_(0, s.steps.long().reshape(1),
                        depth.reshape(1).to(buf.dtype))
        return verify(st, params, s, tr, cos_t, sin_t)

    SE._verify = verify_depth
    try:
        yield
    finally:
        SE._verify = verify


def run_eagle(res, tree=EAGLE_TREE, static_tree=STATIC_TREE,
              train_steps=EAGLE_TRAIN_STEPS, autotune=AUTOTUNE_NODES,
              alpha_plans=ALPHA_PLANS) -> dict:
    """The JAX package's default drafting mode and the others, on the main
    path's target and prompts, graph-replayed and eager (the runs are
    listed in the module docstring, item 8). Every MSD run must
    commit the null-draft tokens of its verify shape: the null EAGLE
    draft's on the EAGLE and static trees, the main path's on the
    48-node medusa_choices tree. Raises on a departure, on a K1 launch
    count other than 32 per AR token decoded, if the no-stop trees are not
    max_depth deep at every step, or if the distilled draft's stop depth
    takes fewer than 3 values."""
    import collections

    import torch
    from msd_tpu_torch.configs import DraftConfig, EngineConfig, TreeConfig
    from msd_tpu_torch.engine import autotune as AT
    from msd_tpu_torch.engine import spec_engine as SE
    from msd_tpu_torch.engine.generator import MSDGenerator
    from msd_tpu_torch.engine.static_tree import mc_sim_7b_63
    from msd_tpu_torch.models import draft as D
    from msd_tpu_torch.ops import decode_attention as K1
    from msd_tpu_torch.train.data_gen import record_from_traj
    from msd_tpu_torch.train.trainer import DraftTrainer, tree_map

    c = res["ctx"]
    t0 = time.perf_counter()
    base = c["gens"]["graph"]
    tp, tcfg = base.params["target"], base.tcfg
    prompts, feats, dev, sync = c["prompts"], c["feats"], c["device"], \
        c["sync"]
    max_new, warm, captures = c["max_new"], c["max_new_warm"], \
        c["captures"]
    dtype, max_seq = tp["embed_tokens"].dtype, base.eng.max_seq_len
    dcfg = DraftConfig(text=tcfg)       # medusa_heads=0: EAGLE recursion
    out = {"alpha": {}, "ms_per_step": {}}

    def eagle_draft(seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        dp = D.init_draft_params(dcfg, g, dev, dtype)
        dp["embed_tokens"] = tp["embed_tokens"]
        return dp

    def engine(tree_kw):
        return EngineConfig(max_seq_len=max_seq, prompt_pad_multiple=128,
                            tree=TreeConfig(**tree_kw))

    def make(tree_kw, draft, graphs, d_cfg=dcfg):
        return MSDGenerator(tp, draft, tcfg, d_cfg, engine(tree_kw),
                            n_img=base.n_img, eos_id=base.eos_id,
                            sp=base.sp, device=dev, cuda_graphs=graphs)

    drafts = {"random": eagle_draft(21), "null": eagle_draft(22)}
    depth_buf = torch.zeros(max_seq, dtype=torch.int32, device=dev)

    def serve(gen, label, pis=(0, 1), **kw):
        """An untimed warm-up request (it captures), then timed requests
        on the prompts ``pis``, none of which may capture. Returns
        [(result, seconds, stop depths)]."""
        gen.generate(prompts[0], feats, warm, **kw)
        n_cap = captures(gen)[0]
        runs = []
        for pi in pis:
            sync()
            t1 = time.perf_counter()
            r = gen.generate(prompts[pi], feats, max_new, **kw)
            sync()
            secs = time.perf_counter() - t1
            tok = np.asarray(r.tokens)
            if tok.shape != (max_new,) or tok.min() < 0 \
                    or tok.max() >= tcfg.vocab_size:
                raise AssertionError(f"[eagle] {label}: bad tokens "
                                     f"{tok.shape} {tok[:8]}")
            if gen.graphs is not None and not gen.graphs.reads(r.graph,
                                                               gen.params):
                raise AssertionError(f"[eagle] {label}: replayed a graph "
                                     f"captured for other weights")
            runs.append((r, secs, depth_buf[:r.accept_steps].cpu().numpy()
                         .copy()))
        if captures(gen)[0] != n_cap:
            raise AssertionError(f"[eagle] {label}: a capture inside the "
                                 f"timed runs")
        return runs

    def report(label, runs, want, key=None):
        """Tokens == ``want`` per prompt (raises otherwise); prints alpha,
        ms/step and the stop-depth histogram; returns the depths seen."""
        for pi, (r, _, _) in enumerate(runs):
            if not np.array_equal(r.tokens, want[pi]):
                raise AssertionError(f"[eagle] {label} prompt {pi}: tokens "
                                     f"differ from the null-draft tokens")
        steps = sum(r.accept_steps for r, _, _ in runs)
        alpha = sum(r.accept_len_sum for r, _, _ in runs) / max(steps, 1)
        secs = sum(t for _, t, _ in runs)
        depths = np.concatenate([d for _, _, d in runs])
        hist = dict(sorted(collections.Counter(depths.tolist()).items()))
        log(f"[eagle] {label}: == null-draft tokens on {len(runs)} "
            f"prompt(s): True; alpha {alpha:.3f} over {steps} steps, "
            f"{secs * 1e3 / max(steps, 1):.2f} ms/step (prefill included); "
            f"stop depth (deepest valid node) histogram {hist}")
        if key is not None:
            out["alpha"][key] = alpha
            out["ms_per_step"][key] = secs * 1e3 / max(steps, 1)
        return set(hist)

    n_layers = tcfg.num_hidden_layers
    with stop_depths(depth_buf):
        # 1. random EAGLE draft, bench's eagle tree, graph and eager, the
        # null EAGLE draft's tokens as the reference; the AR baseline
        graph = make(tree, drafts["random"], True)
        eager = make(tree, drafts["random"], False)
        graph.naive_generate(prompts[0], feats, warm, share_prefill=True)
        graph.params["draft"] = drafts["null"]
        null = serve(graph, "null EAGLE draft")
        canon = [r.tokens for r, _, _ in null]
        graph.params["draft"] = drafts["random"]
        K1.decode_attention.launches = 0
        rnd = serve(graph, "random draft, graph")
        ar_decoded = 0
        for ids in prompts:
            r = graph.naive_generate(ids, feats, max_new, share_prefill=True)
            ar_decoded += len(r.tokens) - 1
        launches = K1.decode_attention.launches
        expected = n_layers * ar_decoded if c["on_card"] else 0
        log(f"[eagle] K1 launches {launches} (random-draft MSD and the AR "
            f"baseline), expected {expected} (= {n_layers} layers x "
            f"{ar_decoded} AR tokens decoded)")
        if launches != expected:
            raise AssertionError(f"[eagle] K1 launch count {launches} != "
                                 f"{expected}")
        out["k1_launches"] = launches
        report("random draft, graph", rnd, canon, "random")
        report("random draft, eager", serve(eager, "random draft, eager"),
               canon)
        same48 = all(np.array_equal(a, b) for a, b in zip(canon, c["null"]))
        log(f"[eagle] the {tree['num_nodes']}-node null-draft tokens == the "
            f"main path's {1 + sum(c['widths'])}-node ones: {same48}")

        # 2. no stop: every step runs and keeps all max_depth layers
        no_stop = dict(tree, early_stop_threshold=-1.0)
        graph.eng, eager.eng = engine(no_stop), engine(no_stop)
        out["no_stop_depths"] = report(
            "no stop, graph", serve(graph, "no stop, graph"), canon,
            "no stop")
        report("no stop, eager", serve(eager, "no stop, eager", (0,)), canon)
        if out["no_stop_depths"] != {tree["max_depth"]}:
            raise AssertionError(f"[eagle] no-stop trees of depths "
                                 f"{out['no_stop_depths']}, want "
                                 f"{tree['max_depth']} at every step")

        # 3. distilled: one record -> train round with bench's settings on
        # the random draft's collected trajectories, served by set_draft
        graph.eng, eager.eng = engine(tree), engine(tree)
        coll = serve(graph, "collecting hiddens", collect_hiddens=True)
        report("collecting hiddens", coll, canon)
        got = [r for r, _, _ in coll]
        n_img = base.n_img
        pad_rec = ((len(prompts[0]) + n_img - 1 + max_new + 127) // 128) \
            * 128
        emb_host = tp["embed_tokens"].float().cpu().numpy()
        feats_host = feats.float().cpu().numpy()
        recs = [record_from_traj(r.traj_hidden, r.exp_ids, c["e0"], 1, n_img,
                                 feats_host, emb_host, pad_rec) for r in got]
        sync()
        t1 = time.perf_counter()
        trainer = DraftTrainer(dcfg, drafts["random"], tp["lm_head"],
                               bench_trainer_config(train_steps, 1e-3,
                                                    pad_rec))
        hist = []
        while trainer.step_count < train_steps:
            hist.append(trainer.run_epoch([], recs, log=lambda *a: None))
        sync()
        train_s = time.perf_counter() - t1
        trained = {k: tree_map(lambda t: t.detach().to(dtype), v)
                   for k, v in trainer.params.items() if k != "embed_tokens"}
        trained["embed_tokens"] = tp["embed_tokens"]
        steps_done = trainer.step_count
        del trainer
        log(f"[eagle] trained the EAGLE draft: {steps_done} steps (batch 2 "
            f"x {pad_rec} rows, lr 1e-3) in {train_s:.2f}s, "
            f"{train_s / steps_done:.4f} s/step; loss "
            f"{hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f}, top1_agree "
            f"{hist[0]['top1_agree']:.3f} -> {hist[-1]['top1_agree']:.3f}")
        out["train_s_per_step"] = train_s / steps_done
        graph.set_draft(trained)
        eager.set_draft(trained)
        dist = serve(graph, "distilled, graph")
        out["distilled_depths"] = report("distilled, graph", dist, canon,
                                         "distilled")
        dist_e = serve(eager, "distilled, eager")
        report("distilled, eager", dist_e, canon)
        for (a, _, _), (b, _, _) in zip(dist, dist_e):
            if (a.accept_steps, a.accept_len_sum) != \
                    (b.accept_steps, b.accept_len_sum):
                raise AssertionError("[eagle] distilled: graph and eager "
                                     "accepted differently")
        if len(out["distilled_depths"]) < 3:
            raise AssertionError(f"[eagle] the distilled draft's stop depth "
                                 f"took {out['distilled_depths']}, want 3 or "
                                 f"more values")
        col = serve(graph, "collecting calibration",
                    collect_calibration=True)
        report("collecting calibration", col, canon)
        rows = []
        for r, _, _ in col:
            valid = r.calib_data["valid"].astype(bool)
            rows.append({k: v[valid] for k, v in r.calib_data.items()})
        graph.set_calibrator(bench_fit(rows, tcfg.vocab_size, dev,
                                       "[eagle]"))
        report("distilled, calibrated, graph",
               serve(graph, "calibrated", use_calibration=True), canon,
               "calibrated")
        del eager

        # 4. static trees: mc_sim_7b_63 on the EAGLE drafts, medusa_choices
        # on the main path's medusa draft (its 48-row verify: the main
        # path's null-draft tokens)
        st_kw = dict(static_tree, static_choices=mc_sim_7b_63)
        sgraph = make(st_kw, drafts["null"], True)
        static_canon = [r.tokens for r, _, _ in serve(sgraph,
                                                      "static, null")]
        sgraph.set_draft(trained)
        report("mc_sim_7b_63 static tree, graph",
               serve(sgraph, "static, graph"), static_canon, "static")
        report("mc_sim_7b_63 static tree, eager",
               serve(make(st_kw, trained, False), "static, eager", (0,)),
               static_canon)
        del sgraph
        widths = c["widths"]
        mc_kw = dict(top_k=widths[0], max_depth=len(widths),
                     num_nodes=1 + sum(widths),
                     medusa_choices=MEDUSA_CHOICES)
        medusa = c["drafts"]["msd"]
        mgraph = make(mc_kw, medusa, True, base.dcfg)
        report("medusa_choices tree, graph",
               serve(mgraph, "medusa_choices, graph"), c["null"],
               "medusa_choices")
        report("medusa_choices tree, eager",
               serve(make(mc_kw, medusa, False, base.dcfg),
                     "medusa_choices, eager", (0,)), c["null"])

        # 5. the autotuners; a request after each re-tune equals a fresh
        # generator's on the picked tree
        t1 = time.perf_counter()
        graph.autotune_tree(candidates=autotune, log=lambda m: log(
            f"[eagle] {m}"))
        picked = dataclasses.asdict(graph.eng.tree)
        log(f"[eagle] autotune_tree picked num_nodes "
            f"{picked['num_nodes']} in {time.perf_counter() - t1:.1f}s")
        fresh = make(picked, trained, True)
        for a, b in zip(serve(graph, "re-tuned"), serve(fresh, "fresh")):
            _same_request("autotune_tree", a[0], b[0])
        del fresh
        t1 = time.perf_counter()
        base_tree = dataclasses.replace(mgraph.eng.tree, medusa_choices=None)
        tuned = AT.autotune_tree_alpha(
            mgraph, [AT.widths_tree(w, base_tree) for w in alpha_plans],
            prompts[0], feats, max_new=max_new, log=lambda m: log(
                f"[eagle] {m}"))
        log(f"[eagle] autotune_tree_alpha picked widths "
            f"{tuned['picked_widths']} in {time.perf_counter() - t1:.1f}s")
        out["alpha_tune"] = tuned
        fresh = make(dataclasses.asdict(mgraph.eng.tree), medusa, True,
                     base.dcfg)
        for a, b in zip(serve(mgraph, "alpha re-tuned"),
                        serve(fresh, "alpha fresh")):
            _same_request("autotune_tree_alpha", a[0], b[0])
        del fresh, mgraph

    def profile():
        """The EAGLE expansion alone (max_depth - 1 unrolled frontier
        forwards and finalize_tree), finalize_tree alone and the medusa
        expansion, each recorded with its inputs from an eager step and
        replayed in a CUDA graph; then the EAGLE expansion's kernels by
        name (one eager call, profiled)."""
        calls = {}

        def recorder(owner, name):
            real = getattr(owner, name)

            def record(*args, **kwargs):
                calls.setdefault(name, []).append((real, args, kwargs))
                return real(*args, **kwargs)
            return real, record

        eager = make(tree, trained, False)
        wraps = [(SE, "_draft_expand"), (SE.tree_mod, "finalize_tree")]
        reals = []
        for owner, name in wraps:
            real, record = recorder(owner, name)
            reals.append(real)
            setattr(owner, name, record)
        try:
            eager.generate(prompts[0], feats, 2)
            c["gens"]["eager"].generate(prompts[0], feats, 2)
        finally:
            for (owner, name), real in zip(wraps, reals):
                setattr(owner, name, real)
        runs = {"eagle": calls["_draft_expand"][0],
                "medusa": calls["_draft_expand"][-1],
                "finalize": calls["finalize_tree"][0]}
        ms = {name: graph_ms(lambda i, f=f, a=a, k=k: f(*a, **k), 1)
              for name, (f, a, k) in runs.items()}
        log(f"[eagle] expansion alone (graph replay): EAGLE "
            f"({tree['max_depth'] - 1} unrolled depths + finalize_tree, "
            f"{tree['num_nodes']} nodes) {ms['eagle']:.3f} ms, of which "
            f"finalize_tree {ms['finalize']:.3f} ms; medusa "
            f"({len(c['widths']) - 1} heads, {1 + sum(c['widths'])} nodes) "
            f"{ms['medusa']:.3f} ms")
        f, a, k = runs["eagle"]
        device_profile(lambda: f(*a, **k), "EAGLE expansion, one eager "
                       "call", top=8)
        out["expand_ms"] = ms

    out["profile"] = profile
    out["seconds"] = time.perf_counter() - t0
    log(f"[eagle] phase took {out['seconds']:.1f}s")
    return out


def _same_request(label, a, b):
    if not (np.array_equal(a.tokens, b.tokens)
            and (a.accept_steps, a.accept_len_sum)
            == (b.accept_steps, b.accept_len_sum)):
        raise AssertionError(f"[eagle] {label}: the re-tuned generator's "
                             f"request differs from a fresh generator's")
    log(f"[eagle] {label}: re-tuned == fresh generator (tokens, steps, "
        f"accepted): True; alpha {a.avg_accept_len:.3f}")


def main():
    t_start = time.perf_counter()
    card = phase_device()
    import torch
    from msd_tpu_torch.configs import LlamaConfig
    phase_build()
    k1, profile_k1 = phase_kernels(card)
    tcfg = dataclasses.replace(LlamaConfig.llava_7b(),
                               residual_dtype="float32")
    t_main = time.perf_counter()
    res = run_main_path(tcfg, WIDTHS, MAX_SEQ, MAX_NEW, N_IMG, PROMPT_TOKENS)
    k1["launches"] = res["launches"]
    log(f"[main] timed runs: graph-replayed {res['graph_s']:.1f}s, eager "
        f"{res['eager_s']:.1f}s; phase took "
        f"{time.perf_counter() - t_main:.1f}s")
    run_calib(res)
    sampling = run_sampling(res)
    distill = run_distill(res)
    eagle = run_eagle(res)
    profile_k1()
    res["profile"]()
    sampling["profile"]()
    distill["profile"]()
    eagle["profile"]()
    log(f"[done] total wall {time.perf_counter() - t_start:.1f}s on {card}")
    print(json.dumps({"kernels": [k1]}), flush=True)
    print(smi_name_and_limit(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
