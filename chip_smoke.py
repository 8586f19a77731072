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
   decode step) at four kv_len and at kv_len 0 (K1's fixed cost), and at
   Qwen2-VL-7B's AR row (T=1, Hq=28, Hkv=4: G*T = 7, the kernel's wide
   regime) over 384 caches at kv_len 272 (cold in L2 as well) beside
   SDPA with enable_gqa; at the multi-visual prompts' AR rows
   (``time_k1_row``: LLaVA's at kv_len 1220 and 2200 over a 2688-row
   cache, Qwen2-VL's video row at 2340 over a 3072-row cache, each cold
   in L2, beside its plain twin, SDPA and its bound); and,
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
9. serve (``run_serve``): the serving path on the main path's weights:
   the CLIP ViT-L/14-336 tower and mlp2x_gelu projector (bf16, seeded)
   encode a seeded 336x336 image (ms per image; its rows against the
   same weights in fp32), whose rows feed every image request;
   ``generate_batch`` of 32 tokens at B = 1, 2, 3, 4, 8 over image
   prompts and at B = 2, 3, 4, 8 over text prompts (every lane must
   commit the null-draft tokens of the same B and its solo run's, graph
   == eager; for the first lane that departs
   from its solo run, the first op whose rows differ (``lane_divergence``)
   before the phase fails; the replayed step with and without the
   per-lane products; ms/step wall and per replayed step, aggregate
   tokens/s; no K1 launch, no capture in a timed window); a 4-slot
   continuous batcher, segment 16, over 8 image and text requests with
   staggered submission and mixed max_new (every request == the
   null-draft run of the same schedule, each text request alone in the
   slots == the mixed run; segments, joins, aggregate tokens/s);
   ``generate_stream`` (chunks == one-shot); the HTTP server in
   continuous mode on a free port: concurrent text, image_b64 (a PNG
   made from numpy) and stream requests, each text equal to its solo
   repeat, and a ``use_msd: false`` request whose K1 launches must be 32
   per AR token decoded (the kernels line's ``serve_launches``).
10. weights (``run_weights``): the main path's target, the ``[serve]``
   tower and projector written as an HF-layout LLaVA checkpoint (bf16,
   <= 5 GB shards, index, config.json) and the main draft by
   ``save_draft``, in a temporary directory removed at the end (the phase
   fails if the disk cannot hold it); ``load_llava``/``load_draft`` must
   give every tensor bitwise; the server ``server.main`` builds from the
   directory (``LlavaMSD.from_pretrained``) answers a text, an image,
   a stream and a ``use_msd: false`` request, each equal to a generator
   over the weights in memory; K1 launches 32 per AR token decoded.
   Write and load seconds.
11. harness (``run_harness``), on the checkpoint ``run_weights`` leaves
   to ``main``, which removes it after ``[train]``: the eval CLI
   ``msd_tpu_torch.harness.__main__.main`` called in process,
   ``HARNESS_LIMIT`` (6) synthetic docs of synthetic_vqa, pope and
   ai2d_ppl, ``HARNESS_NEW`` (16) new tokens:
   calibrated MSD with online calibration (train_ratio 0.5, the
   calibrator fitted and pickled at the boundary), the AR adapter
   ``llava``, the calibrated run again from the pickle (skip_to_test)
   and MSD with the null draft. Calibrated == skip_to_test == null-draft
   responses and token ids; calibrated == AR token ids up to each
   request's first split, and every split a tie of the target's logits
   within 2 bf16 ulps; loglikelihoods bitwise equal across runs and
   repeats and equal to a plain recompute (unpadded, built apart from
   the scoring program) within 1e-4; K1 only in the AR run, 32 per AR
   step run (a capture's warm-up steps included); no capture after a
   combination's first request. Seconds per task, ms per generated
   token, alpha, the splits and the target's usual top-1 margin, the AR
   run's greedy share, peak memory.
11b. harness_ext (``run_harness_ext``), on the same checkpoint: the
   extended tier through the same CLI, ``HARNESS_EXT_LIMIT`` (2) docs of
   mme_realworld_lite, mmlu (loglikelihood), llava_in_the_wild,
   mmbench_en_dev, mmaad_base and a YAML task written to the temporary
   directory and registered by ``--include_path``, ``--judge
   endpoint:URL`` at a loopback stub (an ``http.server`` thread with
   fixed replies): calibrated MSD from ``[harness]``'s pickle, the AR
   adapter, the null draft, and the calibrated run on the judged tasks
   with the judge at a dead loopback port. Calibrated == null-draft ==
   dead-judge responses and token ids; AR against calibrated by
   ``[harness]``'s tie rule; mmlu's loglikelihoods bitwise across runs
   and repeats, within 1e-4 of the plain recompute; K1 only in the AR
   run; the stub served exactly the calls the scorers make, every score
   is the rule's for the stub's reply (the dead judge's: the offline
   rule's, which must differ). Seconds per run, ms per token.
12. quant (``run_quant``): on prompt 0 x 32 tokens, an int8 target, an
   int4 target and the bf16 target with an int8 draft: MSD == null-draft
   tokens, graph ==
   eager, the oracle draft accepted to full depth, K1 32 per AR token;
   the int8 draft's tokens == the bf16 draft's. Replayed AR token and
   verify step beside the bf16 main path's, peak memory.
12b. multi (``run_multi``), on the main path's target and drafts and
   ``[serve]``'s tower and projector, on generators of their own
   (max_seq_len 2560, 64-row prompt buckets) released after the phase:
   seeded images through the native prep (timed against PIL), then (a)
   two 336px images at two placeholders, (b) a 1008x672 image through
   anyres ('spatial_unpad', a seeded newline: 2144 rows), (c) S2 at (336,
   672, 1008) with a seeded 3072 -> 4096 projector, (d) one image through
   the prefused and the standard prefill; graph, eager and null-draft MSD
   and AR. Fails unless MSD == eager == null draft, every committed
   token passes the recompute gate (``token_check``), AR (and (d)'s
   standard path) departs only at a near-tie, K1 launches 32 per AR
   token, and a planted fusion fault is rejected. Prefill ms, replayed
   ms per step, the towers' ms.
13. profiles: one AR and one MSD request (prefill + 16 tokens), graph and
   eager: wall, device time, idle share of the request and of its decode
   range, top kernels; in the graph AR request the profiler must count as
   many K1 launches as the wrapper's count, 32 per AR token decoded; a
   sampled MSD request and the acceptance walk's share of its step; one
   train step of the distillation: device time, the GEMMs' share, and its
   fp32 operations (counted from the shapes) against the card's fp32
   peak; the EAGLE expansion alone against the medusa expansion; the
   continuous schedule's device time and idle share.
14. train (``run_train``), after every 7B tensor of the earlier phases is
   released, on the ``[weights]`` checkpoint (LLaVA-1.5-7B width, read
   back by each command): ``python -m msd_tpu_torch.train``'s
   ``gen-data`` (``main`` in process, 8 text conversations) and
   ``generate_dataset`` (4 seeded images through the tower and
   projector), every record in the JAX layout; ``fit`` over both
   record directories (19 steps), its epoch-1 loss below its epoch-0
   loss on the same text records, its export bitwise the trainer's bf16
   cast and, through ``set_draft``, committing the null-draft tokens;
   ``LlavaFinetuner`` stage 1 (the LM bitwise its host snapshot, the
   projector moved, the first loss within 1e-3 of an eager recompute;
   a planted stage-1 optimizer that also updates the LM must fail that
   gate) and stage 2 over all 7B parameters in bf16 (update 0 at lr 0
   leaves the LM, update 1 moves it, unused embedding rows stay
   bitwise); ``pipeline`` over the checkpoint and fit's export, its
   distilled draft committing the null-draft tokens. K1 never launches.
   ms per step of fit and both stages (one fit step and one stage-2
   step profiled), records/s, the pipeline's seconds, alpha before and
   after, peak memory per stage.
15. 13b (``run_13b``), after every 7B tensor is released: LLaVA-13B with an
   int8 target (40 layers, hidden 5120, 40 heads) and two bf16 medusa
   drafts initialised on the card from seeded generators, the target
   quantized layer by layer; one image prompt x 16 tokens, MSD, null-draft
   MSD and AR, graph-replayed: MSD == the null-draft tokens, K1 40 per AR
   token decoded; K1 against its plain twin at 40 heads and timed there
   beside the twin, SDPA and its bound.
16. qwen (``run_qwen``), after the 13B model is released: Qwen2-VL-7B at
   full width from seeded generators (the GQA 28/4 decoder with q/k/v
   biases, bf16 weights, fp32 residual; the 32-layer tower on a seeded
   336px image, 144 merged rows; 13-head medusa and null drafts at its
   width): two 64-token prompts with the inline image span and a text
   prompt, ``QWEN_NEW`` (24) new tokens each, graph, eager and null-draft MSD and the AR
   baseline, the oracle draft after the image, ``generate_batch`` at
   B = 2; ``save_qwen2_vl`` and ``save_draft`` write the checkpoint, read
   back bitwise, and the harness CLI runs ``qwen2_vl_msd`` on it (MSD, AR,
   the null draft). Fails unless MSD == eager == null draft, every
   committed token is the canonical argmax of an independent mrope
   recompute at the verify's row shapes, exactly, and of an unpadded one
   or within 2 bf16 ulps of its top plus that row's gap between the two
   recomputes, AR departs from MSD only at such ties, the same gate rejects MSD with a
   planted fault (a verify without pos_delta), the oracle is accepted to full depth, the
   batch equals the solo runs, K1 launches 28 per AR token decoded (0 in
   MSD) and the scores are bitwise repeatable and equal their recompute
   within 1e-4. One Qwen2-VL training record (``make_qwen_record_from_
   ids`` over image prompt 0) must have the JAX layout and hidden rows
   bitwise those of an independent mrope recompute at its row shape and
   within 2^-3 (row-relative L2) of an unpadded one. Its ``[video]`` part
   (``run_video``): 32 seeded 336px frames through the tower's video path
   (16 temporal blocks, 2304 rows; ms per video, peak memory), held to
   its plain block-per-block evaluation, which a planted cross-block
   attention must fail; then the ``qwen2_vl_msd`` adapter's
   ``video_gen`` over the same tensors: MSD == null draft, the mrope
   recompute gate at grid_t 16, AR against MSD by ``QWEN_TIE``, K1 28
   per AR token.
17. qwen_v1 (``run_qwen_v1``), after Qwen2-VL is released: Qwen-VL (v1)
   at full width from seeded generators (the Qwen-1 decoder, 32 layers,
   hidden 4096, 32 heads without GQA, vocab 151936, 1-D rope, q/k/v
   biases, bf16 weights, fp32 residual; the 48 x 1664 ViT-bigG tower with
   its 256-query resampler on a seeded 448px image; 13-head medusa and
   null drafts): two 64-token prompts around the v1 span <img> <imgpad> x
   256 </img> (ids 151857, 151859, 151858, found only through the
   generator's ``inline_pad_ids``) and a text prompt, ``QWEN_NEW`` (24)
   new tokens each,
   graph, eager and null-draft MSD and the AR baseline; the checkpoint in
   the public Qwen/Qwen-VL names read back by ``load_qwen_vl_v1``
   bitwise; the harness CLI's ``qwen_vl_eagle`` on it, B its default
   (AR) and A ``--use_msd``. Fails unless MSD == eager == null draft,
   every committed token passes the recompute gate (the span spliced in
   by concatenation at 1-D positions), AR departs from MSD only at ties,
   K1 launches 32 per AR token (0 in MSD), A's and B's ai2d_ppl scores
   are bitwise equal and within 1e-4 of their recompute, the bf16 tower
   is within ``V1_TOWER_TOL`` of its fp32 evaluation, and two planted
   faults are rejected on measured quantities: (a) a generator without
   ``inline_pad_ids`` by its first decode row's logits against the
   recompute, beyond the true generator's gap; (b) the resampler's keys
   without their positions by the tower's error and by that row. K1 is
   timed at the phase's AR row (32 heads, kv_len ~338, S = 1280).

The line before the last is the card's name and power limit; the line
before that a JSON object with one entry per kernel; the last line
{"ok": true, "device": {...}}. Imports nothing of JAX or of msd_tpu.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import os
import shutil
import subprocess
import sys
import tempfile
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
# lm_head sharpened x6; this run decodes 40 new tokens per prompt (64
# until [multi] and [video] joined the smoke, 48 until the rest of the
# extended tier joined [harness_ext] and [qwen]: cut to keep it inside its
# time limit; the main path's, [calib]'s, [sampling]'s, [distill]'s
# collection and [eagle]'s runs read it)
MAX_SEQ, MAX_NEW, N_IMG, PROMPT_TOKENS = 1152, 40, 576, 64
WIDTHS = (10, 8, 6, 5, 4, 3, 2, 2, 2, 1, 1, 1, 1, 1)
ROUND_BITS, HEAD_SHARPEN = 6, 6.0
# bench.py's distill (1700 steps over 5 record -> train rounds) cut to two
# rounds of 50 steps (~0.5 s a step at 7B width), the schedule's floor, so
# the whole smoke, [qwen] included, stays near 1000 s on the card
DISTILL_STEPS, DISTILL_ROUNDS = 100, 2
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
# the serving phase: batch sizes of generate_batch, the continuous
# batcher's slots and segment, new tokens per HTTP request
SERVE_BATCHES, SERVE_SLOTS, SERVE_SEGMENT = (1, 2, 3, 4, 8), 4, 16
SERVE_HTTP_NEW = 32
# new tokens of each generate_batch run of [serve] (graph, null draft,
# eager and the solo runs alike), cut from the main path's 64 when [train]
# joined the smoke, from 32 when [multi] and [video] did and from 24 when
# the rest of the extended tier did, to keep it inside its time limit
SERVE_BATCH_NEW = 16
# new tokens of [quant]'s runs (a prefix of the main path's: greedy
# tokens do not depend on the budget), of [13b]'s and of [qwen]'s,
# [video]'s and [qwen_v1]'s generator runs, cut from 64, 32 and 64 when
# [train] joined the smoke, and [qwen]'s from 32 when [qwen_v1] did and
# from 24 when the rest of the extended tier did, to keep it inside its
# time limit
QUANT_NEW, NEW_13B, QWEN_NEW = 32, 16, 16
# the harness phase: its tasks (two generation tasks, one scored by
# loglikelihood), synthetic docs per task and new tokens per request
HARNESS_TASKS = ("synthetic_vqa", "pope", "ai2d_ppl")
# (32 new tokens until [multi] and [video] joined the smoke, 8 docs until
# [qwen_v1] did, 6 until the rest of the extended tier did)
HARNESS_LIMIT, HARNESS_NEW = 4, 16
# where the AR adapter's tokens first depart from MSD's, the target's
# logits of the two tokens must lie within this many bf16 ulps of the
# larger plus that row's recompute noise (a tie that bf16 rounding
# decides; ``split_ok``), or K1's recompute of the AR row must pick AR's
# token within K1's contract (a text-only prompt split at 7 ulps against a
# 1-ulp noise of the plain recomputes on one H100: K1's arithmetic)
HARNESS_TIE = 2
# the extended-tier harness phase: one task of each task module of the
# extended tier (mmlu, scored by loglikelihood, and mme_realworld_lite
# from tasks_ext; mmvetv2 from tasks_ext2; ifeval, text only, from
# tasks_ext3 with the IFEval checkers; wildvision_0617 and the two-image
# llava_interleave_bench from tasks_judge2; librispeech_test_clean, audio
# only, from tasks_audio; live_bench from tasks_ext4; the three-round
# mmsearch_end2end from tasks_mmsearch), a YAML task registered through
# --include_path, and synthetic docs per task; its judged tasks; the
# rounds each doc of a multi-round task runs; the loopback judge's reply
# to a prompt holding each marker (the llava pairwise review, the mmbench
# option match, the mmvet rubric (mmvetv2's too), the mathvista
# extraction, the wildvision verdict, the live_bench rating and the
# video-QA rubric), each a score no offline rule gives
HARNESS_EXT_TASKS = ("mme_realworld_lite", "mmlu", "llava_in_the_wild",
                     "mmbench_en_dev", "mmaad_base", "mmvetv2", "ifeval",
                     "wildvision_0617", "librispeech_test_clean",
                     "live_bench", "mmsearch_end2end",
                     "llava_interleave_bench")
HARNESS_EXT_YAML = "smoke_yaml_vqa"
HARNESS_EXT_JUDGED = ("llava_in_the_wild", "mmbench_en_dev", "mmvetv2",
                      "wildvision_0617", "live_bench")
HARNESS_EXT_LIMIT = 2
HARNESS_EXT_ROUNDS = {"mmsearch_end2end": 3}
JUDGE_REPLIES = (("[Context]", "8 6\nAssistant 2 was decent."),
                 ("Your output:", "A"),
                 ("Correctness", "0.5"),
                 ("Extracted answer:", "B"),
                 ("<|User Prompt|>", "B is more specific.\n[[B>A]]"),
                 ('{"Rating": n', '{"Rating": 7, "Explanation": "stub"}'),
                 ("video-based question-answer",
                  "{'pred': 'yes', 'score': 4}"))
# the Qwen phases: synthetic docs per harness task (4 until [qwen_v1]
# joined the smoke), and the std of the q/k/v biases drawn into the seeded
# target (Qwen's attention has them; zeros would leave the bias add
# untested)
QWEN_LIMIT, QWEN_BIAS_STD = 2, 0.1
# [qwen]'s harness runs also take one video task of tasks_ext2 and one of
# tasks_ext3 through the adapter's video_gen, at this many frames per
# video (--model_args max_num_frames): 2 temporal blocks, 288 merged
# rows, where the adapter's default 32 frames (2304 rows) would not fit
# the harness runs' 1152-row cache
QWEN_VIDEO_TASKS, QWEN_HARNESS_FRAMES = ("activitynetqa",
                                         "vitatecs_direction"), 4
# how far (bf16 ulps of the top logit) a committed Qwen token may lie below
# the independent recompute's top logit when it is not the recompute's
# canonical argmax, on the card, and how far apart the two tokens of an
# AR-vs-MSD split may lie: HARNESS_TIE's 2 (one step of the 6-bit
# canonical grid), plus that row's bf16 noise as measured against a
# recompute at the verify's row shapes (for a split, the AR row's too;
# ``qwen_token_check``); 0 off the card (fp32), where every token must be
# the canonical argmax
QWEN_TIE = HARNESS_TIE
# [train]'s fit --lr: TrainConfig's 2000-step warmup scales the rate of
# update k by k / 2000 (the CLI has no warmup flag), so 0.01 runs the 19
# updates at 0 to 9.5e-5 (epoch 0: up to 1.5e-5). The CLI's default 2e-4
# stays below 2e-6, where the input noise outweighs the learning; on the
# card 0.2 (up to 4e-4 by update 4) sent the loss from 4 to 478
FIT_LR = 0.01
# a Qwen2-VL training record's hidden rows against the unpadded mrope
# recompute, per row relative L2 error on the card: the record runs 256
# rows with a bf16 residual, the recompute 210, whose products round
# otherwise over 28 layers (measured on one H100: worst row 2.994e-02);
# a misplaced image row or position is O(1). Against a recompute at the
# record's own row shape the rows must be bitwise equal.
QWEN_RECORD_TOL = 2 ** -3
# [multi]: the multi-visual generators' cache (the anyres prompt's 2207
# rows, a tree and its path fit below it) and new tokens per request (32
# until the rest of the extended tier joined the smoke)
MULTI_SEQ, MULTI_NEW = 2560, 16
# [video]: frames per video (32 frames of 336px: 16 temporal blocks, 2304
# merged rows) and the tower's rows against its plain block-per-block
# evaluation (relative L2 over all rows) on the card, bf16 both: the two
# run the same per-block attention, but their products over 9216 and 576
# rows may round otherwise; a video attending across its temporal blocks
# is far off (measured on one H100: 0, the two bitwise equal, and 0.127
# with the planted cross-block attention). Off the card (fp32) 1e-5.
VIDEO_FRAMES, VIDEO_TOWER_TOL = 32, 2 ** -6
# [qwen_v1]: the image span's ids of the public Qwen/Qwen-VL model
# (config.json's visual.image_start_id 151857; </img> and <imgpad> follow
# it), which differ from Qwen2-VL's, so the engine finds the span only
# through inline_pad_ids; the harness tasks of its qwen_vl_eagle runs
V1_IMG_START, V1_IMG_END, V1_IMG_PAD = 151857, 151858, 151859
V1_HARNESS_TASKS = ("synthetic_vqa", "ai2d_ppl")
# the v1 tower's bf16 rows against its fp32 evaluation on the card
# (relative L2 over all 256 rows; measured on one H100: 5.3e-3); off the
# card (fp32 both) 1e-5. And its fp32 evaluation against the remote
# code's replica (``v1_tower_replica``), fp32 both, which the planted
# fault of keys without their positions must exceed: at random weights
# the 48 blocks pull the ViT's rows together, so that fault moves the
# rows by about as much as bf16 rounding does (measured on one H100:
# 7.2e-3 against the fp32 evaluation, where the true bf16 rows lie at
# 5.3e-3), and only an fp32 comparison tells the two apart.
V1_TOWER_TOL, V1_REPLICA_TOL = 2 ** -6, 1e-4
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
    # Qwen2-VL-7B's AR row: G*T = 7 grouped rows, two row groups of 4 per
    # kv head (the kernel's wide regime); kv_len 272 is a 210-row image
    # prompt after 62 AR tokens; the split grid's edge
    q_split = K1.launch_shape(1, 28, 4, K1.sm_count(0))[2]
    cases += [(1, 28, 4, 1280, n, bf16) for n in (1, 272, 1279, q_split + 1)]
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
    # Qwen2-VL-7B's AR row at kv_len 272: 28 layer caches would hold 15.6
    # MB of live K/V, inside the 50 MB L2, where on the AR path ~500 MB of
    # layer weights pass between two attention calls; 384 hold 214 MB
    entry["qwen_ar"] = time_k1_row(
        card, f"Qwen2-VL AR row (G*T = 7: 2 row groups of 4 per kv head, "
        f"{q_split} splits)", 28, 4, 272, 1280, 384)
    # the multi-visual prompts' AR rows: [multi]'s LLaVA generators (S =
    # 2688 for max_seq_len 2560 + a 48-node tree) after the two-image
    # (e0 1214) and the anyres (e0 2207) prompts, and [video]'s Qwen2-VL
    # video_gen (S = 3072 for max_seq_len 2944) after its ~2340-row prompt
    s_multi = -128 * (-(MULTI_SEQ + 1 + sum(WIDTHS)) // 128)
    entry["multi_ar"] = {
        name: time_k1_row(card, f"LLaVA AR row, {name} prompt", 32, 32,
                          kv_len, s_multi, 32)
        for name, kv_len in (("two-image", 1220), ("anyres", 2200))}
    entry["video_ar"] = time_k1_row(card, "Qwen2-VL AR row, video prompt",
                                    28, 4, 2340, 3072, 64)

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
        idx = (s.cur_len[:, None] - e0 + tr.positions).long()
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


def _replay_ms(gen, index: int, n: int = 16) -> float:
    """Device ms per replay of capture ``index``: n back-to-back replays
    between CUDA events (whatever its lanes hold: a step computes every
    lane)."""
    import torch
    step = gen.graphs.steps[index]
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        step()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


_VIEW_OPS = {"view", "_unsafe_view", "as_strided", "select", "slice",
             "expand", "transpose", "t", "permute", "unsqueeze", "squeeze",
             "unflatten", "reshape", "alias", "detach", "lift_fresh",
             "_to_copy_alias"}


def _op_log(compare=None, lanes=1, lane=0):
    """A dispatch mode over the port's ops: without ``compare``, it records
    (op, where, output) of every op that makes new values (views and
    in-place writes skipped); with ``compare`` (such a record of a one-lane
    run), it holds the rows of ``lane`` of each op of a ``lanes``-lane run
    against the next op of the record with the same name and matching
    shape, and keeps the first that differs. ``where`` names the port's
    source line that issued the op and, inside ``llama_forward``, the
    layer."""
    import os

    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    root = os.path.dirname(os.path.abspath(__file__))

    def where():
        f = sys._getframe(2)
        while f is not None and "msd_tpu_torch" not in f.f_code.co_filename:
            f = f.f_back
        if f is None:
            return "?"
        return (f"{os.path.relpath(f.f_code.co_filename, root)}:"
                f"{f.f_lineno} ({f.f_code.co_name})")

    def rows(out, ref):
        if out.dim() and ref.dim() and out.shape[1:] == ref.shape[1:] and \
                out.shape[0] == lanes * ref.shape[0]:
            return out.reshape((lanes, ref.shape[0]) + out.shape[1:])[lane]
        return out if out.shape == ref.shape else None

    class OpLog(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops, self.pos, self.compared, self.in_verify = [], 0, 0, 0
            self.first = self.first_verify = None
            self.layer, self.verify = None, False

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = func.overloadpacket.__name__
            res = out[0] if isinstance(out, (tuple, list)) and out else out
            if (name in _VIEW_OPS or name.endswith("_")
                    or getattr(func, "is_view", False)
                    or not isinstance(res, torch.Tensor)):
                return out
            loc = where() + ("" if not self.verify else " in the verify"
                             + ("" if self.layer is None
                                else f", layer {self.layer}"))
            if compare is None:
                self.ops.append((name, loc, res.detach().clone()))
                return out
            if self.first_verify is not None:
                return out
            for k in range(self.pos, min(self.pos + 8, len(compare))):
                cname, cloc, ref = compare[k]
                mine = rows(res, ref) if cname == name else None
                if mine is None or mine.dtype != ref.dtype:
                    continue
                self.pos = k + 1
                self.compared += 1
                self.in_verify += self.verify
                if not torch.equal(mine, ref):
                    err = float((mine.double() - ref.double()).abs()
                                .nan_to_num().max()) \
                        if mine.is_floating_point() else float("nan")
                    diff = (name, loc, tuple(res.shape), tuple(ref.shape),
                            err)
                    self.first = self.first or diff
                    if self.verify:
                        self.first_verify = diff
                break
            return out

    return OpLog()


def lane_divergence(gen, prompts, feats, max_new: int, lane: int,
                    max_steps: int = 4) -> str:
    """Why lane ``lane`` of a batch of ``prompts`` (one image-row tensor or
    None each) commits other tokens than its solo run: prefill both (a
    state of the batch's lane count and a one-lane state), compare the
    lane's state with the solo state, then step both eagerly in lockstep
    (``decode_step``, every lane live up to ``max_new``) and, at the first
    step where any of the lane's op outputs differs from the solo run's,
    name the first such op and compare the verify forward's per-layer
    hiddens. Returns the report line."""
    import torch
    from msd_tpu_torch.engine import spec_engine as SE
    from msd_tpu_torch.models import llama as Lm

    lanes = 1 << (len(prompts) - 1).bit_length()
    st = gen._statics(max_new, lanes=lanes)

    def prefilled(ps, fs, n):
        state = gen.alloc_lanes(n)
        for i, (ids, f) in enumerate(zip(ps, fs)):
            ids, padded, img_pos = gen._prompt(ids)
            SE.prefill(st, gen.params, SE.lane(state, i), padded, len(ids),
                       f, img_pos)
        state.stop_at.zero_()
        state.stop_at[:len(ps)] = max_new
        return state

    bstate = prefilled(prompts, feats, lanes)
    sstate = prefilled([prompts[lane]], [feats[lane]], 1)
    mine, solo = SE.lane(bstate, lane), SE.lane(sstate, 0)
    e = int(solo.cur_len)
    fields = [n for n in ("ids", "cur_len", "bonus", "suffix_tokens",
                          "suffix_hidden", "suffix_len", "draft_len")
              if not torch.equal(getattr(mine, n), getattr(solo, n))]
    fields += [f"target_kv.{k}" for k in ("k", "v") if not torch.equal(
        mine.target_kv[k][:, :e], solo.target_kv[k][:, :e])]
    parts = [f"prefill: lane state == solo state: "
             f"{not fields}{'' if not fields else f' (differ: {fields})'}"]

    real_layer, real_verify = Lm._layer_forward, SE.verify_forward
    hiddens = []
    mode = {"log": None, "verify": False, "layer": 0}

    def layer(*a, **kw):
        if mode["verify"] and mode["log"] is not None:
            mode["log"].layer = mode["layer"]
        x = real_layer(*a, **kw)
        if mode["verify"]:
            hiddens.append(x.detach().clone())
            mode["layer"] += 1
        return x

    def verify(*a, **kw):
        mode["verify"], mode["layer"] = True, 0
        if mode["log"] is not None:
            mode["log"].verify = True
        try:
            return real_verify(*a, **kw)
        finally:
            mode["verify"] = False
            if mode["log"] is not None:
                mode["log"].layer, mode["log"].verify = None, False

    Lm._layer_forward, SE.verify_forward = layer, verify
    try:
        for step in range(1, max_steps + 1):
            hiddens.clear()
            rec = mode["log"] = _op_log()
            with rec:
                SE.decode_step(st, gen.params, sstate)
            solo_h = list(hiddens)
            hiddens.clear()
            cmp = mode["log"] = _op_log(rec.ops, lanes, lane)
            with cmp:
                SE.decode_step(st, gen.params, bstate)
            cur = int(solo.cur_len)
            same_ids = torch.equal(mine.ids[:cur + 1], solo.ids[:cur + 1])
            per_layer = [float((h[lane].double() - s[0].double()).abs()
                               .max()) for h, s in zip(hiddens, solo_h)]
            del rec
            def said(diff):
                name, loc, shp, ref_shp, err = diff
                return (f"aten.{name} at {loc}, output {shp} against the "
                        f"solo {ref_shp}, max |diff| {err:.3e}")

            line = (f"step {step} ({cmp.compared} ops compared, "
                    f"{cmp.in_verify} of the verify forward): ")
            if cmp.first is None:
                parts.append(line + f"all equal, committed ids equal "
                             f"{same_ids}")
                continue
            line += f"first differing op {said(cmp.first)}"
            if cmp.first_verify is None:
                parts.append(line + f"; the verify forward equal; "
                             f"committed ids equal {same_ids}")
                continue
            nz = [i for i, d in enumerate(per_layer) if d > 0]
            parts.append(
                line + f"; first differing op of the verify forward "
                f"{said(cmp.first_verify)}; verify hiddens differ from "
                f"layer {nz[0] if nz else None} on, max |diff| per layer "
                f"{[float(f'{d:.2e}') for d in per_layer]}; committed ids "
                f"equal {same_ids}")
            break
    finally:
        Lm._layer_forward, SE.verify_forward = real_layer, real_verify
        mode["log"] = None
        del bstate, sstate
    return "; ".join(parts)


def lane_step_ms(gen, prompts, feats, max_new: int, lanes: int,
                 per_lane=None) -> float:
    """Device ms per replayed verify step on a fresh state of ``lanes``
    lanes whose first lanes hold ``prompts`` prefilled: with the products
    the lane count computes one lane at a time (``Statics.per_lane``), or
    with ``per_lane`` in their place (``frozenset()``: every product over
    all lanes' rows). The state and its graph are released after."""
    from msd_tpu_torch.engine import spec_engine as SE
    st = gen._statics(max_new, lanes=lanes)
    if per_lane is not None:
        st = dataclasses.replace(st, per_lane=per_lane)
    state = gen.alloc_lanes(lanes)
    try:
        for b, (ids, f) in enumerate(zip(prompts, feats)):
            ids, padded, img_pos = gen._prompt(ids)
            SE.prefill(st, gen.params, SE.lane(state, b), padded, len(ids),
                       f, img_pos)
        return _replay_ms(gen, gen.step_fn(SE.decode_step, st, state).index)
    finally:
        gen._release(state)


def _png_b64(image: np.ndarray) -> str:
    import base64
    import io

    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(image).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def run_serve(res, vision=None, batches=SERVE_BATCHES, n_slots=SERVE_SLOTS,
              segment=SERVE_SEGMENT, http_new=SERVE_HTTP_NEW) -> dict:
    """The serving path on the main path's weights and generators: the CLIP
    tower and projector (ViT-L/14-336 by default, bf16 from a seeded
    generator) encode a seeded 336x336 image whose rows feed every image
    request; ``generate_batch`` at each B of ``batches``; a continuous
    batcher of ``n_slots`` slots over 8 mixed image/text requests with
    staggered submission and mixed max_new; ``generate_stream``; and the
    HTTP server in continuous mode on a free port (concurrent text, image,
    stream and ``use_msd: false`` requests, /health). Raises unless every
    batched lane (image and text prompts) and every slot commits the
    null-draft tokens of its own batched run (the same B, the same
    schedule) and the tokens of its request run alone, graph == eager,
    stream == one-shot, every HTTP text equals its solo repeat, the
    batched runs launch no K1 and the ``use_msd: false`` request launches
    32 per AR token decoded. A lane that departs from its solo run is
    explained (``lane_divergence``) before the phase fails. On the card it
    also times the replayed step of B = 3 on 3 lanes (unpadded) and, at
    4 and 8 lanes, with and without the per-lane products."""
    import threading
    import urllib.request

    import torch
    from msd_tpu_torch.configs import (IMAGE_TOKEN_INDEX, ClipVisionConfig,
                                       LlavaConfig)
    from msd_tpu_torch.models import llava as LV
    from msd_tpu_torch.ops import decode_attention as K1
    from msd_tpu_torch.serve import server as S
    from msd_tpu_torch.harness.models.llava_msd import (LlavaMSD,
                                                         SimpleTokenizer)
    from msd_tpu_torch.serve.continuous import ContinuousScheduler, Request
    from msd_tpu_torch.utils.mm_utils import process_image

    ctx = res["ctx"]
    gens, drafts, tcfg = ctx["gens"], ctx["drafts"], ctx["tcfg"]
    sync, on_card, device = ctx["sync"], ctx["on_card"], ctx["device"]
    max_new, warm = ctx["max_new"], ctx["max_new_warm"]
    gen, eager = gens["graph"], gens["eager"]
    n_layers = tcfg.num_hidden_layers
    t_phase = time.perf_counter()
    out = {}

    # 1. the vision tower and projector; one image, encoded once
    vcfg = vision or ClipVisionConfig()
    lcfg = LlavaConfig(text=tcfg, vision=vcfg)
    dtype = gen.params["target"]["embed_tokens"].dtype
    g = torch.Generator(device=device).manual_seed(7)
    from msd_tpu_torch.models import clip_vit as CV
    lp = {"vision": CV.init_clip_params(vcfg, g, device, dtype),
          "projector": LV.init_projector_params(lcfg, g, device, dtype)}
    rng = np.random.default_rng(7)
    image = rng.integers(0, 256, size=(vcfg.image_size, vcfg.image_size, 3),
                         dtype=np.uint8)
    pixels = torch.from_numpy(process_image(image, vcfg.image_size)) \
        .to(device)
    feats = LV.encode_image(lp, lcfg, pixels)
    sync()
    t1 = time.perf_counter()
    for _ in range(5):
        feats = LV.encode_image(lp, lcfg, pixels)
    sync()
    clip_ms = (time.perf_counter() - t1) * 1e3 / 5
    lp32 = {k: {n: (w.float() if not isinstance(w, dict) else
                    {m: x.float() for m, x in w.items()})
                for n, w in v.items()} for k, v in lp.items()}
    ref = LV.encode_image(lp32, lcfg, pixels)
    rel = float((feats.float() - ref).norm() / ref.norm())
    if feats.shape != (vcfg.num_patches, tcfg.hidden_size) \
            or not bool(torch.isfinite(feats).all()) or rel > 0.25:
        raise AssertionError(f"[serve] image rows {tuple(feats.shape)}, "
                             f"finite {bool(torch.isfinite(feats).all())}, "
                             f"relative error against fp32 {rel:.4f}")
    del lp32, ref
    out["clip_ms"] = clip_ms
    log(f"[serve] CLIP tower ({vcfg.num_hidden_layers} layers, hidden "
        f"{vcfg.hidden_size}, {vcfg.num_patches + 1} tokens, "
        f"{vcfg.num_hidden_layers + 1 + vcfg.select_layer} blocks run) + "
        f"projector in {dtype}: {clip_ms:.2f} ms per {vcfg.image_size}px "
        f"image (eager, no graph), rows {tuple(feats.shape)}, relative "
        f"error against the same weights in fp32 {rel:.4f}")

    # the smoke's prompt shape: 64 tokens, the image at index 1
    rng = np.random.default_rng(11)
    vocab_hi = min(31000, tcfg.vocab_size - 1)
    n_tok = len(ctx["prompts"][0])

    def prompt(with_image):
        ids = rng.integers(3, vocab_hi, size=n_tok).astype(np.int32)
        if with_image:
            ids[1] = IMAGE_TOKEN_INDEX
        return ids

    img_prompts = list(ctx["prompts"]) + [prompt(True) for _ in range(
        max(batches) - len(ctx["prompts"]))]
    txt_prompts = [prompt(False) for _ in range(max(batches))]

    def captures():
        return [s for s in gen.graphs.steps if s is not None] \
            if gen.graphs is not None else []

    # generate_batch runs decode a prefix of the main path's tokens
    batch_new = min(max_new, SERVE_BATCH_NEW)
    # 2. generate_batch at each B: warm-ups capture one graph per (draft,
    # B) outside the timed window
    for B in batches:
        for name in ("null", "msd"):
            gen.params["draft"] = drafts[name]
            gen.generate_batch(img_prompts[:B], [feats] * B, warm)
        eager.generate_batch(img_prompts[:B], [feats] * B, warm)
    gen.params["draft"] = drafts["msd"]
    sync()
    n_cap = len(captures())
    K1.decode_attention.launches = 0
    out["batch"], out["text_batch"] = {}, {}
    differing = None
    for B, kind in [(B, "image") for B in batches] + \
            [(B, "text") for B in batches if B > 1]:
        ps = (img_prompts if kind == "image" else txt_prompts)[:B]
        fs = [feats if kind == "image" else None] * B
        runs = {}
        for name in ("msd", "null"):
            gen.params["draft"] = drafts[name]
            t1 = time.perf_counter()
            rs = gen.generate_batch(ps, fs, batch_new)
            sync()
            runs[name] = (rs, time.perf_counter() - t1)
            if gen.graphs is not None and not gen.graphs.reads(
                    rs[0].graph, gen.params):
                raise AssertionError(f"[serve] B={B} {name}: replayed a "
                                     f"graph captured for other weights")
        gen.params["draft"] = drafts["msd"]
        ers = eager.generate_batch(ps, fs, batch_new)
        rs, secs = runs["msd"]
        for b in range(B):
            tok = rs[b].tokens
            if tok.shape != (batch_new,) or tok.min() < 0 \
                    or tok.max() >= tcfg.vocab_size:
                raise AssertionError(f"[serve] B={B} {kind} lane {b}: bad "
                                     f"tokens {tok.shape} {tok[:8]}")
            if not np.array_equal(tok, runs["null"][0][b].tokens):
                raise AssertionError(f"[serve] B={B} {kind} lane {b}: MSD "
                                     f"tokens differ from the null-draft "
                                     f"tokens of the same batch")
            if not np.array_equal(tok, ers[b].tokens):
                raise AssertionError(f"[serve] B={B} {kind} lane {b}: graph "
                                     f"and eager tokens differ")
        solo = [np.array_equal(
            gen.generate(ps[b], fs[b], batch_new).tokens, rs[b].tokens)
            for b in range(B)]
        if differing is None and not all(solo):
            differing = (kind, ps, fs, solo.index(False))
        lanes = 1 << (B - 1).bit_length()
        per_lane = sorted(gen._statics(batch_new, lanes=lanes).per_lane)
        if kind == "text":
            out["text_batch"][B] = solo
            log(f"[serve] generate_batch B={B}, text prompts: every lane "
                f"== its null-draft tokens of the same B: True; graph == "
                f"eager: True; batched == solo per lane: {solo}")
            continue
        steps = max(r.accept_steps for r in rs)
        toks = sum(len(r.tokens) for r in rs)
        alpha = sum(r.accept_len_sum for r in rs) / \
            sum(r.accept_steps for r in rs)
        step_ms = _replay_ms(gen, rs[0].graph) if on_card else float("nan")
        out["batch"][B] = {"ms_step": secs * 1e3 / steps,
                           "replay_ms": step_ms, "tok_s": toks / secs,
                           "solo": solo, "lanes": lanes,
                           "per_lane": per_lane}
        log(f"[serve] generate_batch B={B} on {lanes} lanes (verify "
            f"products per lane: {per_lane}): every lane == its null-draft "
            f"tokens of the same B: True; graph == eager: True; batched == "
            f"solo per lane: {solo}; {steps} steps, "
            f"{secs * 1e3 / steps:.2f} ms/step wall incl. the {B} "
            f"prefills, {step_ms:.3f} ms per replayed step (device), "
            f"aggregate {toks / secs:.1f} tokens/s, alpha {alpha:.3f}")
    launches = K1.decode_attention.launches
    if launches or len(captures()) != n_cap:
        raise AssertionError(f"[serve] batched runs: {launches} K1 launches "
                             f"(want 0: MSD verifies through "
                             f"windowed_attention), "
                             f"{len(captures()) - n_cap} captures in the "
                             f"timed window")
    lanes = sorted({(s.key[4][0], s.index) for s in captures()
                    if s.key[0].__name__ == "decode_step"})
    log(f"[serve] captures (B, index) of the verify step so far: {lanes}; "
        f"one per (configuration, draft, B); none in a timed window")
    # a lane that departs from its solo run: the first op whose rows
    # differ, then the phase fails
    if differing is not None:
        kind, ps, fs, b = differing
        report = lane_divergence(eager, ps, fs, batch_new, b)
        log(f"[serve] batched != solo, {kind} B={len(ps)} lane {b}: "
            f"{report}")
        raise AssertionError(f"[serve] {kind} B={len(ps)} lane {b}: "
                             f"batched tokens differ from its solo run")
    # the price of the padded lanes and of the per-lane products
    if on_card:
        out["unpadded_3_ms"] = lane_step_ms(gen, img_prompts[:3],
                                            [feats] * 3, batch_new, 3)
        out["route"] = {}
        for n in (4, 8):
            if n > max(batches):
                continue
            args = (gen, img_prompts[:n], [feats] * n, batch_new, n)
            ms = [lane_step_ms(*args), lane_step_ms(*args, frozenset()),
                  lane_step_ms(*args, frozenset()), lane_step_ms(*args)]
            out["route"][n] = {"per_lane": min(ms[0], ms[3]),
                               "one_product": min(ms[1], ms[2])}
        log(f"[serve] replayed step, B=3 on 3 lanes (unpadded): "
            f"{out['unpadded_3_ms']:.3f} ms; " + "; ".join(
                f"{n} lanes with the products "
                f"{out['batch'][n]['per_lane']} per lane "
                f"{v['per_lane']:.3f} ms, every product over all lanes "
                f"{v['one_product']:.3f} ms (+"
                f"{v['per_lane'] - v['one_product']:.3f} ms, "
                f"{(v['per_lane'] - v['one_product']) / v['one_product']:.3f}"
                f" of the step)" for n, v in out["route"].items()))

    # 3. continuous batching: one scheduler, the same schedule with the
    # random and the null draft
    sched = ContinuousScheduler(gen, n_slots=n_slots, segment=segment)
    plan = [(0, True, 64), (0, False, 24), (0, True, 48), (1, False, 32),
            (2, True, 64), (2, False, 40), (4, True, 16), (6, False, 56)]
    plan = [(at, img, min(n, max_new)) for at, img, n in plan]
    sched_prompts = [img_prompts[i % len(img_prompts)] if img
                     else prompt(False) for i, (_, img, _) in enumerate(plan)]

    def run_schedule(draft, which=range(len(plan)), n_new=None):
        """The requests ``which`` of the plan, each submitted at its
        segment, through ``sched`` with the ``draft`` draft."""
        gen.params["draft"] = drafts[draft]
        reqs = [Request(ids=sched_prompts[i], img_feats=feats
                        if plan[i][1] else None,
                        max_new=n_new or plan[i][2], seed=i) for i in which]
        schedule = [plan[i] for i in which]
        seg0, joined0 = sched.steps, sched.joined
        t1 = time.perf_counter()
        submitted = 0
        while submitted < len(reqs) or sched.busy:
            # a request joins at its segment, or at once when all slots
            # have drained before it
            while submitted < len(reqs) and (
                    schedule[submitted][0] <= sched.steps - seg0
                    or not sched.busy):
                sched.submit(reqs[submitted])
                submitted += 1
            sched.step()
        sync()
        gen.params["draft"] = drafts["msd"]
        return (reqs, time.perf_counter() - t1, sched.steps - seg0,
                sched.joined - joined0)

    for name in ("null", "msd"):
        run_schedule(name, (0, 1), warm)
    n_cap = len(captures())
    msd, secs, segs, joins = run_schedule("msd")
    null = run_schedule("null")[0]
    for i, (a, b) in enumerate(zip(msd, null)):
        if a.error or not np.array_equal(a.tokens, b.tokens) \
                or len(a.tokens) != plan[i][2]:
            raise AssertionError(f"[serve] continuous request {i}: error "
                                 f"{a.error}, or its tokens differ from the "
                                 f"null-draft run of the same schedule")
    if len(captures()) != n_cap:
        raise AssertionError("[serve] continuous: a capture in the timed "
                             "run")
    # a slot's tokens do not depend on what the other slots hold: each
    # text request alone in the slots commits its tokens of the mixed run
    alone = [np.array_equal(run_schedule("msd", (i,))[0][0].tokens,
                            msd[i].tokens)
             for i, (_, img, _) in enumerate(plan) if not img]
    if not all(alone):
        raise AssertionError(f"[serve] continuous: a text request alone in "
                             f"the slots differs from the mixed run: "
                             f"{alone}")
    solo = [np.array_equal(gen.generate(r.ids, r.img_feats,
                                        r.max_new).tokens, r.tokens)
            for r in msd]
    if not all(solo):
        raise AssertionError(f"[serve] continuous: requests differ from "
                             f"their solo runs: {solo}")
    toks = sum(len(r.tokens) for r in msd)
    out["continuous"] = {"segments": segs, "joins": joins,
                         "tok_s": toks / secs, "solo": solo}
    log(f"[serve] continuous, {n_slots} slots, segment {segment}: 8 "
        f"requests (4 image, 4 text, max_new "
        f"{[n for _, _, n in plan]}, submitted at segments "
        f"{[at for at, _, _ in plan]}): every request == its null-draft "
        f"tokens under the same schedule: True; {segs} segments, {joins} "
        f"joins, {toks} tokens in {secs:.2f}s, aggregate "
        f"{toks / secs:.1f} tokens/s; each text request alone in the "
        f"slots == in the mixed run: {alone}; == solo generate: {solo}")

    # 4. streaming
    one = gen.generate(img_prompts[0], feats, max_new)
    chunks = list(gen.generate_stream(img_prompts[0], feats, max_new,
                                      segment=segment))
    if len(chunks) < 2 or not np.array_equal(np.concatenate(chunks),
                                             one.tokens):
        raise AssertionError(f"[serve] stream: {len(chunks)} chunks, "
                             f"concatenation differs from generate's tokens")
    log(f"[serve] generate_stream: {len(chunks)} chunks of "
        f"{[len(c) for c in chunks]} tokens == generate's tokens: True")

    # 5. the HTTP server, continuous mode
    sched.close()
    del sched
    adapter = LlavaMSD.from_llava(gen, SimpleTokenizer(tcfg.vocab_size), lp,
                                  lcfg)
    httpd = S.serve_forever(adapter, port=0, continuous=n_slots,
                            segment=segment)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    port = httpd.server_address[1]

    def post(payload, path="/generate"):
        rq = urllib.request.Request(
            f"http://127.0.0.1:{port}{path}",
            data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(rq, timeout=300) as r:
            if path == "/generate_stream":
                return [json.loads(line) for line in r]
            return json.loads(r.read())

    b64 = _png_b64(image)
    payloads = {"text": {"prompt": "Describe the weather in one sentence.",
                         "max_new_tokens": http_new},
                "text2": {"prompt": "List three colors.",
                          "max_new_tokens": http_new // 2},
                "image": {"prompt": "What is in the picture?",
                          "image_b64": b64, "max_new_tokens": http_new}}
    try:
        t1 = time.perf_counter()
        got = {}
        threads = [threading.Thread(target=lambda k=k, p=p: got.__setitem__(
            k, post(p))) for k, p in payloads.items()]
        threads.append(threading.Thread(target=lambda: got.__setitem__(
            "stream", post(dict(payloads["text"], segment=8),
                           "/generate_stream"))))
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        concurrent_s = time.perf_counter() - t1
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/health",
                                    timeout=60) as r:
            health = json.loads(r.read())
        same = {}
        for k, p in payloads.items():
            again = post(p)
            same[k] = got[k]["text"] == again["text"] and \
                got[k]["tokens_generated"] == again["tokens_generated"] > 0
        stream_text = "".join(x["text"] for x in got["stream"][:-1]).strip()
        same["stream"] = got["stream"][-1].get("done") is True and \
            stream_text == got["text"]["text"]
        K1.decode_attention.launches = 0
        ar = post(dict(payloads["image"], use_msd=False))
        launches = K1.decode_attention.launches
    finally:
        S.shutdown(httpd)
    decoded = ar["tokens_generated"] - 1
    want = n_layers * decoded if on_card else 0
    out["serve_launches"] = launches
    log(f"[serve] HTTP, continuous {n_slots} slots: concurrent text, text, "
        f"image_b64 and stream requests in {concurrent_s:.2f}s; each == "
        f"its solo repeat (stream == its text's /generate): {same}; "
        f"/health {health}; use_msd=false: K1 launches {launches}, expected "
        f"{want} (= {n_layers} layers x {decoded} AR tokens decoded)")
    if not all(same.values()) or launches != want:
        raise AssertionError(f"[serve] HTTP: {same}, K1 launches {launches} "
                             f"!= {want}")

    def profile():
        """The continuous schedule once more, profiled: its device time and
        idle share."""
        nonlocal sched
        sched = ContinuousScheduler(gen, n_slots=n_slots, segment=segment)
        prof = device_profile(lambda: run_schedule("msd"),
                              f"continuous {n_slots} slots, 8 requests",
                              top=8)
        out["continuous"]["idle"] = 1 - prof["busy_us"] / prof["wall_us"]
        sched.close()

    out["profile"] = profile
    out["llava"], out["lcfg"], out["image"] = lp, lcfg, image
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[serve] phase took {out['seconds']:.1f}s")
    return out


def _flat_tensors(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_tensors(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _map_tensors(tree, fn):
    """The nested dict ``tree`` with ``fn`` applied to every tensor."""
    return {k: _map_tensors(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _bitwise_diff(label, mine, ref) -> list:
    """Names of the tensors of ``mine`` that are not bitwise those of
    ``ref`` (same keys, shapes and dtypes)."""
    import torch
    a, b = _flat_tensors(mine), _flat_tensors(ref)
    if sorted(a) != sorted(b):
        return [f"{label}: keys {sorted(set(a) ^ set(b))}"]
    return [f"{label}/{k}" for k in a
            if a[k].dtype != b[k].dtype or a[k].shape != b[k].shape
            or not torch.equal(a[k], b[k])]


def run_weights(res, serve, http_new=SERVE_HTTP_NEW, root=None) -> dict:
    """Serving from a checkpoint: the main path's target, the CLIP tower
    and projector of ``[serve]`` written as an HF-layout LLaVA checkpoint
    (bf16, shards of at most 5 GB, index and config.json) and the main
    draft with ``save_draft``, in a temporary directory deleted at the
    end; the checkpoint loaded back (``load_llava``, ``load_draft``: every
    tensor bitwise the in-memory one); the server ``server.main`` builds
    (``parse_args`` and ``server_from_args``: ``LlavaMSD.
    from_pretrained``) answering a text, an image, a stream and a
    ``use_msd: false`` request one at a time, each equal to a generator
    over the in-memory weights with the adapter's configuration (tokens,
    and the served text and count); the AR request's K1 launches = layers
    x AR tokens decoded. Fails when the disk cannot hold the checkpoint
    (it is never shrunk). Given ``root``, the checkpoint is written there
    and left to the caller, which hands ``out["ckpt"]`` and
    ``out["draft"]`` to ``run_harness`` and removes it."""
    import gc
    import shutil
    import tempfile
    import threading
    import urllib.request

    import torch
    from msd_tpu_torch.engine.generator import MSDGenerator
    from msd_tpu_torch.ops import decode_attention as K1
    from msd_tpu_torch.serve import server as S
    from msd_tpu_torch.harness.models.llava_msd import LlavaMSD
    from msd_tpu_torch.utils import weights as W

    ctx = res["ctx"]
    gen, drafts, tcfg = ctx["gens"]["graph"], ctx["drafts"], ctx["tcfg"]
    sync, on_card = ctx["sync"], ctx["on_card"]
    device = ctx["device"]
    tp = gen.params["target"]
    lp, lcfg = serve["llava"], serve["lcfg"]
    dtype = tp["embed_tokens"].dtype
    t_phase = time.perf_counter()
    params = {"target": tp, **lp}
    ckpt_bytes = sum(t.numel() for t in W.hf_llava_state(params).values()) \
        * dtype.itemsize
    draft_bytes = 4 * sum(t.numel() for k, t in
                          _flat_tensors(drafts["msd"]).items()
                          if k != "embed_tokens")
    own = root is None
    root = tempfile.mkdtemp(prefix="msd_ckpt_") if own else root
    out = {}
    try:
        free = shutil.disk_usage(root).free
        log(f"[weights] checkpoint {ckpt_bytes / 1e9:.3f} GB ({dtype}) + "
            f"draft {draft_bytes / 1e9:.3f} GB (fp32) to write under "
            f"{root}; free disk {free / 1e9:.1f} GB")
        if free < 1.05 * (ckpt_bytes + draft_bytes):
            raise AssertionError(f"[weights] the disk cannot hold the "
                                 f"checkpoint: {free / 1e9:.1f} GB free")
        ckpt, ddir = f"{root}/llava", f"{root}/draft"
        t1 = time.perf_counter()
        written = W.save_llava(params, lcfg, ckpt, dtype)
        written += os.path.getsize(W.save_draft(drafts["msd"], ddir))
        out["write_s"] = time.perf_counter() - t1
        shards = [os.path.getsize(os.path.join(ckpt, f)) / 1e9
                  for f in sorted(os.listdir(ckpt))
                  if f.endswith(".safetensors")]
        log(f"[weights] wrote {written / 1e9:.3f} GB in "
            f"{out['write_s']:.1f}s: {len(shards)} shards of "
            f"{[round(x, 2) for x in shards]} GB, index, config.json, the "
            f"draft; free disk now "
            f"{shutil.disk_usage(root).free / 1e9:.1f} GB")

        # loaded back: bitwise the tensors in memory
        t1 = time.perf_counter()
        loaded, lcfg2 = W.load_llava(ckpt, dtype, device)
        dloaded, dcfg2 = W.load_draft(ddir, lcfg2.text,
                                      loaded["target"]["embed_tokens"],
                                      dtype, device)
        sync()
        out["load_s"] = time.perf_counter() - t1
        bad = _bitwise_diff("target", loaded["target"], tp) \
            + _bitwise_diff("vision", loaded["vision"], lp["vision"]) \
            + _bitwise_diff("projector", loaded["projector"],
                            lp["projector"]) \
            + _bitwise_diff("draft", dloaded, drafts["msd"])
        n_tensors = sum(len(_flat_tensors(x)) for x in (loaded, dloaded))
        log(f"[weights] load_llava + load_draft in {out['load_s']:.1f}s: "
            f"{n_tensors} tensors, bitwise equal to the weights in memory: "
            f"{not bad}; medusa heads {dcfg2.medusa_heads}, tower "
            f"{lcfg2.vision.num_hidden_layers} layers at "
            f"{lcfg2.vision.image_size}px")
        if bad or dcfg2.medusa_heads != len(ctx["widths"]) - 1 \
                or lcfg2.vision != lcfg.vision:
            raise AssertionError(f"[weights] the loaded checkpoint differs "
                                 f"from the weights in memory: {bad[:8]}")
        del loaded, dloaded
        gc.collect()

        # the server server.main runs, on a free port and a thread
        t1 = time.perf_counter()
        args = S.parse_args(["--pretrained", ckpt, "--msd_model_path", ddir,
                             "--port", "0", "--max-seq-len",
                             str(gen.eng.max_seq_len), "--device",
                             str(device)])
        httpd = S.server_from_args(args)
        sync()
        out["serve_load_s"] = time.perf_counter() - t1
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        adapter = httpd.worker.adapter
        agen = adapter.gen
        ref = MSDGenerator(tp, drafts["msd"], agen.tcfg, agen.dcfg,
                           agen.eng, n_img=agen.n_img, eos_id=agen.eos_id,
                           sp=agen.sp, device=device)
        mem = LlavaMSD.from_llava(ref, adapter.tokenizer, lp, lcfg)
        prep = S.EngineWorker(mem)._prep
        port = httpd.server_address[1]

        def post(payload, path="/generate"):
            rq = urllib.request.Request(
                f"http://127.0.0.1:{port}{path}",
                data=json.dumps(payload).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(rq, timeout=600) as r:
                if path == "/generate_stream":
                    return [json.loads(line) for line in r]
                return json.loads(r.read())

        def text(tokens):
            return adapter.tokenizer.decode(list(tokens),
                                            skip_special_tokens=True).strip()

        payloads = {
            "text": {"prompt": "Describe the weather in one sentence.",
                     "max_new_tokens": http_new},
            "image": {"prompt": "What is in the picture?",
                      "image_b64": _png_b64(serve["image"]),
                      "max_new_tokens": http_new},
            "ar": {"prompt": "What is in the picture?",
                   "image_b64": _png_b64(serve["image"]),
                   "max_new_tokens": http_new, "use_msd": False}}
        same = {}
        try:
            for name, p in payloads.items():
                ids, feats, sp, n, use_msd = prep(p)
                run = ref.generate if use_msd else ref.naive_generate
                want = run(ids, img_feats=feats, max_new_tokens=n, sp=sp)
                _, afeats, _, _, _ = S.EngineWorker(adapter)._prep(p)
                arun = agen.generate if use_msd else agen.naive_generate
                got = arun(ids, img_feats=afeats, max_new_tokens=n, sp=sp)
                K1.decode_attention.launches = 0
                t1 = time.perf_counter()
                served = post(p)
                secs = time.perf_counter() - t1
                launches = K1.decode_attention.launches
                same[name] = (np.array_equal(got.tokens, want.tokens)
                              and (feats is None
                                   or torch.equal(afeats, feats))
                              and served["text"] == text(want.tokens)
                              and served["tokens_generated"]
                              == len(want.tokens) > 0)
                if name == "ar":
                    decoded = len(want.tokens) - 1
                    k1_want = (tcfg.num_hidden_layers * decoded
                               if on_card else 0)
                    out["launches"] = launches
                    log(f"[weights] use_msd=false: K1 launches {launches}, "
                        f"expected {k1_want} (= {tcfg.num_hidden_layers} "
                        f"layers x {decoded} AR tokens decoded)")
                    if launches != k1_want:
                        raise AssertionError(f"[weights] K1 launches "
                                             f"{launches} != {k1_want}")
                log(f"[weights] {name} request ({len(want.tokens)} tokens, "
                    f"{secs:.2f}s served): checkpoint generator == "
                    f"in-memory generator, served text and count == its "
                    f"tokens: {same[name]}")
            ids, feats, sp, n, _ = prep(payloads["text"])
            want = ref.generate(ids, img_feats=feats, max_new_tokens=n,
                                sp=sp)
            lines = post(dict(payloads["text"], segment=8),
                         "/generate_stream")
            same["stream"] = (lines[-1].get("done") is True
                              and "".join(x["text"] for x in lines[:-1])
                              .strip() == text(want.tokens))
            log(f"[weights] stream request: {len(lines) - 1} chunks == the "
                f"in-memory generator's text: {same['stream']}")
        finally:
            S.shutdown(httpd)
        if not all(same.values()):
            raise AssertionError(f"[weights] served requests differ from "
                                 f"the in-memory generator: {same}")
        out["same"] = same
        del adapter, agen, httpd, ref, mem
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        out.update(seconds=time.perf_counter() - t_phase, ckpt=ckpt,
                   draft=ddir)
    finally:
        if own:
            shutil.rmtree(root, ignore_errors=True)
    log(f"[weights] write {out['write_s']:.1f}s, load {out['load_s']:.1f}s,"
        f" server.main's load {out['serve_load_s']:.1f}s; phase took "
        f"{out['seconds']:.1f}s")
    return out


def _llava_inputs(gen, ids, feats):
    """The embeddings [rows, H] of the unpadded sequence ``ids`` with the
    image rows spliced in by concatenation, apart from the engine's
    fusion: ``feats`` one block [n_img, H] at the first ``<image>`` token,
    or a list of blocks, one per ``<image>`` token in order; and the
    expanded ids [rows] with -1 on image rows."""
    import torch
    from msd_tpu_torch.configs import IMAGE_TOKEN_INDEX

    ids = np.asarray(ids, np.int64)
    table, dev = gen.params["target"]["embed_tokens"], gen.device
    blocks = [] if feats is None else \
        list(feats) if isinstance(feats, (list, tuple)) else [feats]
    spots = np.nonzero(ids == IMAGE_TOKEN_INDEX)[0][:len(blocks)]
    embs, exp, prev = [], [], 0
    for p, f in zip(list(spots) + [len(ids)], blocks + [None]):
        embs.append(table[torch.from_numpy(ids[prev:p]).to(dev)])
        exp.append(ids[prev:p])
        if f is not None:
            embs.append(f.to(table.dtype))
            exp.append(np.full(len(f), -1))
        prev = p + 1
    return torch.cat(embs), np.concatenate(exp)


def plain_rows_logits(gen, emb, cos, sin):
    """The target's logits over the rows ``emb`` [rows, H] from position
    0, the causal mask by ``triu``, no bucket padding, a cache of exactly
    those rows; ``cos``/``sin`` index by position (the rope tables, or an
    inline prompt's mrope rows). Only ``llama_forward`` and ``lm_head``
    are shared with the engine."""
    import torch
    from msd_tpu_torch.models import llama as L

    tp, dev = gen.params["target"], gen.device
    rows = emb.shape[0]
    mask = torch.full((rows, rows), -1e30, device=dev).triu(1)
    hidden, _ = L.llama_forward(
        tp, gen.tcfg, emb, torch.arange(rows, dtype=torch.int32, device=dev),
        L.init_kv_cache(gen.tcfg, rows, emb.dtype, dev), 0, mask, cos, sin)
    return L.lm_head(tp, hidden)


def plain_logits(gen, ids, feats):
    """The target's fp32 logits over the unpadded sequence ``ids`` with
    the image rows (``feats``: one block, or a list of blocks, one per
    ``<image>`` token) spliced in, built apart from
    ``MSDGenerator.score``'s program and the engine's fusion
    (``_llava_inputs``, ``plain_rows_logits``). Returns (logits [rows, V],
    expanded ids [rows] with -1 on image rows)."""
    emb, exp = _llava_inputs(gen, ids, feats)
    return plain_rows_logits(gen, emb, gen.params["cos_t"],
                             gen.params["sin_t"]), exp


def plain_score(gen, ids, cont_start: int, feats) -> tuple:
    """The plain recompute of ``MSDGenerator.score``: ``plain_logits``,
    then ``log_softmax`` and a gather of the continuation rows' next
    tokens. Returns (logprob_sum, is_greedy)."""
    import torch

    logits, exp = plain_logits(gen, ids, feats)
    off = len(exp) - len(ids)
    logp = torch.log_softmax(logits, dim=-1)
    r = torch.arange(cont_start + off - 1, len(exp) - 1, device=gen.device)
    nxt = torch.from_numpy(exp).to(gen.device)[r + 1]
    return (float(logp[r, nxt].sum()),
            bool((logp[r].argmax(dim=-1) == nxt).all()))


def bf16_ulp(x):
    """The spacing of bf16 values (8 significant bits) at |x|, for a
    float or a tensor."""
    import torch

    t = torch.as_tensor(x, dtype=torch.float32).abs().clamp(min=2 ** -126)
    return torch.exp2(torch.floor(torch.log2(t)) - 7)


@contextlib.contextmanager
def record_harness(sync, run, task_of, ref_run: str, score_task: str,
                   check_run: str = "C", tie: float = 0.0):
    """Wrappers, restored after the block, that record what the harness
    CLI's output does not show: each request's committed token ids, mode
    and graph captures (``MSDGenerator.generate``/``naive_generate``; an
    AR request also its own greedy score), with its prompt's digest, its
    AR steps, the K1 launches it added and the tokens MSD may commit
    before its step limit (``room``), each scoring request (one of
    ``score_task``; in ``check_run`` also a repeat and the plain
    recompute) and the AR steps run (``spec_engine.ar_decode``), tagged
    with the run named ``run[0]`` and ``task_of(run, k)`` for its k-th
    generate request. Yields (requests, scores, [AR steps], settle):
    ``settle()``, called after a run's counts are read, gives each AR
    request of it "split", its ``split_record`` against ``ref_run``'s
    request of the same index (None where the tokens agree; where the gap
    exceeds ``tie`` plus the noise, with ``k1_split_check`` under "k1"
    if ``ar_against_msd`` compares it), "margins", the
    top-1 minus top-2 logit in bf16 ulps of the top-1 at each row of the
    plain recompute that picks one of its tokens, and "k1_check", the K1
    launches those recomputes made."""
    import hashlib

    from msd_tpu_torch.engine import spec_engine as SE
    from msd_tpu_torch.engine.generator import MSDGenerator
    from msd_tpu_torch.engine.graphs import weights_key
    from msd_tpu_torch.ops import decode_attention as K1

    reqs, scores, ar_steps, pending = [], [], [0], []
    orig = {"generate": MSDGenerator.generate,
            "naive_generate": MSDGenerator.naive_generate,
            "score": MSDGenerator.score, "ar_decode": SE.ar_decode}

    def n_graphs(gen):
        return 0 if gen.graphs is None else len(gen.graphs.steps)

    def wrap_gen(kind):
        def wrapped(self, ids, img_feats=None, max_new_tokens=None, **kw):
            before = n_graphs(self)
            k1_0, steps0 = K1.decode_attention.launches, ar_steps[0]
            t1 = time.perf_counter()
            r = orig[kind](self, ids, img_feats, max_new_tokens, **kw)
            sync()
            t2 = time.perf_counter()
            k1 = K1.decode_attention.launches - k1_0
            mode = "ar" if kind == "naive_generate" else \
                "calibrated" if kw.get("use_calibration") else \
                "collect" if kw.get("collect_calibration") else "msd"
            k = sum(q["run"] == run[0] for q in reqs)
            rec = {"run": run[0], "task": task_of(run[0], k),
                   "mode": mode, "t": (t1, t2), "n": len(r.tokens),
                   "tokens": r.tokens.tolist(),
                   "captured": n_graphs(self) - before,
                   "layers": self.tcfg.num_hidden_layers,
                   "prompt": hashlib.sha256(np.asarray(
                       ids, np.int32).tobytes()).hexdigest(),
                   "k1": k1, "ar_steps": ar_steps[0] - steps0,
                   # the tokens MSD may commit before its step limit
                   "room": self._statics(0).step_limit - len(ids)
                   - (self._expansion() if img_feats is not None else 0),
                   # a calibrated step's graph keys on the tables'
                   # tensors: an adapter that installs new tables (each
                   # task's skip_to_test) may capture anew
                   "key": (mode, max_new_tokens, kw.get("sp"),
                           weights_key(self.params["calib"])
                           if mode == "calibrated" else None)}
            if mode == "collect":
                rec["rows"] = int(np.asarray(r.calib_data["valid"]).sum())
            if mode == "ar":
                full = np.concatenate([np.asarray(ids, np.int32),
                                       r.tokens]).astype(np.int32)
                rec["greedy"] = orig["score"](self, full, len(ids),
                                              img_feats)[1]
                ref = [q for q in reqs if q["run"] == ref_run][k]
                pending.append((rec, self, ids, img_feats, ref))
            reqs.append(rec)
            return r
        return wrapped

    def score(self, ids, cont_start, img_feats=None):
        t1 = time.perf_counter()
        got = orig["score"](self, ids, cont_start, img_feats)
        sync()
        rec = {"run": run[0], "task": score_task, "out": got,
               "t": (t1, time.perf_counter())}
        if run[0] == check_run:
            rec["again"] = orig["score"](self, ids, cont_start, img_feats)
            rec["plain"] = plain_score(self, ids, cont_start, img_feats)
        scores.append(rec)
        return got

    def ar_decode(*a, **kw):
        n = orig["ar_decode"](*a, **kw)
        ar_steps[0] += n - 1
        return n

    def settle():
        for rec, gen, ids, feats, ref in pending:
            k1_0 = K1.decode_attention.launches
            logits = llava_logits_fn(gen, ids, feats)
            top2 = logits(rec["tokens"])[:rec["n"]].topk(2, dim=-1).values
            rec["margins"] = ((top2[:, 0] - top2[:, 1])
                              / bf16_ulp(top2[:, 0])).tolist()
            s = rec["split"] = split_record(gen, logits, ref["tokens"],
                                            rec["tokens"])
            # K1's row only where the split is compared: not where MSD
            # stopped at its step limit, nor in a later round after a
            # split, whose prompt is another than MSD's
            if (s is not None and s["ulps"] > tie + s["noise"]
                    and rec["prompt"] == ref["prompt"]
                    and not budget_stop(ref, rec)):
                s["k1"] = k1_split_check(gen, logits, ref["tokens"],
                                         rec["tokens"], s)
            rec["k1_check"] = K1.decode_attention.launches - k1_0
        pending.clear()

    MSDGenerator.generate = wrap_gen("generate")
    MSDGenerator.naive_generate = wrap_gen("naive_generate")
    MSDGenerator.score = score
    SE.ar_decode = ar_decode
    try:
        yield reqs, scores, ar_steps, settle
    finally:
        pending.clear()
        MSDGenerator.generate = orig["generate"]
        MSDGenerator.naive_generate = orig["naive_generate"]
        MSDGenerator.score = orig["score"]
        SE.ar_decode = orig["ar_decode"]


def run_harness(res, ckpt: str, draft_dir: str, root: str,
                limit: int = HARNESS_LIMIT, max_new: int = HARNESS_NEW,
                tasks=HARNESS_TASKS) -> dict:
    """The eval harness on the ``[weights]`` checkpoint (``ckpt``, the
    medusa draft in ``draft_dir``; the main path's null draft is saved
    beside them under ``root``), through its entry point
    ``msd_tpu_torch.harness.__main__.main(argv)`` called in process (its
    JSON print kept off this script's output), ``limit`` synthetic docs
    per task and ``max_new`` new tokens per request:

    A. ``llava_msd_calibrated --use_msd --use_calibration --train_ratio
       0.5`` with a ``calibrator_path``: the first task collects on its
       first half of docs, fits and pickles the calibrator at the
       boundary and decodes the rest with calibrated trees; the later
       tasks read the pickle (``skip_to_test``); ``--log_dir`` and
       ``--output_path`` written;
    B. ``llava``: the AR baseline (K1 in every AR token);
    C. A again with A's pickle: every doc calibrated (``skip_to_test``);
    D. ``llava_msd`` with an independently seeded random draft (the null
       draft) on the generation tasks: the canonical greedy AR.

    What main() returns and writes gives the responses, ``msd_stats``,
    the pickle and the log files; ``record_harness`` records the rest. A
    run's generate requests belong to its generation tasks in order,
    ``limit`` each.

    Fails unless: A's responses and token ids == D's (the window-canonical
    verify makes the committed tokens draft-invariant) and C's == A's;
    A's token ids == B's up to each request's first split, and each split
    is a rounding tie of the target (``split_ok`` of ``split_record``,
    ``HARNESS_TIE``: on the card the AR row, K1, and the verify rows round
    differently in bf16; off the card, in fp32, no split is allowed),
    checked after B's K1 launches are read; A collected on the first
    half of the first task's docs and decoded the rest calibrated, later
    tasks and C decoded every doc calibrated from the pickle, which C left
    as A wrote it, and A wrote acceptance_rate.json and
    calibration_data.json holding its collected rows; the loglikelihoods
    of A, B and C are bitwise equal, two calls of ``score`` on one request
    (C) are bitwise equal and each score is its plain recompute
    (``plain_score``) within 1e-4 x max(1, |lp|) with the same greedy
    flag; K1 launches 0 in A, C, D and in B layers x (AR tokens decoded +
    the warm-up steps of each AR-token capture); no request captures a
    graph after the first request of its (mode, max_new, sampling,
    tables) combination in a run. Whether B's own responses score as
    greedy (the scoring forward reduces over other row counts than the
    AR decode) is printed, and gated off the card."""
    import hashlib
    import io

    import torch
    from msd_tpu_torch.engine.graphs import WARMUP_STEPS
    from msd_tpu_torch.harness import __main__ as HM
    from msd_tpu_torch.ops import decode_attention as K1
    from msd_tpu_torch.utils import weights as W

    ctx = res["ctx"]
    device, on_card, sync = ctx["device"], ctx["on_card"], ctx["sync"]
    card = smi_name_and_limit() if on_card else "cpu"
    tie = HARNESS_TIE if on_card else 0.0
    t_phase = time.perf_counter()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    null_dir = f"{root}/null"
    W.save_draft(ctx["drafts"]["null"], null_dir)
    gen_tasks = [t for t in tasks if t != "ai2d_ppl"]
    run = [None]
    hdir = os.path.join(root, "harness")
    os.makedirs(hdir, exist_ok=True)
    pkl, logdir = f"{hdir}/calibrator.pkl", f"{hdir}/logs"
    # the draft goes by the --msd_model_path flag: an msd_model_path
    # model arg would reach from_pretrained twice (in both packages)
    margs = (f"pretrained={ckpt},"
             f"max_seq_len={ctx['gens']['graph'].eng.max_seq_len}")
    common = ["--device", str(device), "--limit", str(limit),
              "--gen_kwargs", f"max_new_tokens={max_new}", "--log_samples"]
    msd = ["--model", "llava_msd_calibrated", "--use_msd",
           "--use_calibration", "--tasks", ",".join(tasks),
           "--msd_model_path", draft_dir]
    runs = {
        "A": msd + ["--model_args", f"{margs},calibrator_path={pkl}",
                    "--train_ratio", "0.5", "--log_dir", logdir,
                    "--output_path", f"{hdir}/a.json"],
        "B": ["--model", "llava", "--model_args", margs,
              "--msd_model_path", draft_dir, "--tasks", ",".join(tasks)],
        "C": msd + ["--model_args", f"{margs},calibrator_path={pkl}"],
        "D": ["--model", "llava_msd", "--use_msd", "--model_args", margs,
              "--msd_model_path", null_dir, "--tasks", ",".join(gen_tasks)],
    }
    out, digest = {"card": card}, {}
    # B against A's request of the same doc
    with record_harness(sync, run, lambda n, k: gen_tasks[k // limit], "A",
                        "ai2d_ppl", tie=tie) as (reqs, scores, ar_steps,
                                                 settle):
        for name, argv in runs.items():
            run[0] = name
            steps0 = ar_steps[0]
            # the counts of this slice's path: zeroed just before, read
            # just after
            K1.decode_attention.launches = 0
            t1 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                payload = HM.main(argv + common)
            sync()
            out[name] = {"payload": payload, "s": time.perf_counter() - t1,
                         "launches": K1.decode_attention.launches,
                         "ar_steps": ar_steps[0] - steps0}
            # the AR requests' split checks, after the run's count is read
            settle()
            if os.path.exists(pkl):
                with open(pkl, "rb") as f:
                    digest[name] = hashlib.sha256(f.read()).hexdigest()
            gc.collect()
            if on_card:
                torch.cuda.empty_cache()

    def responses(name, task):
        return [s["response"] for s in
                out[name]["payload"]["details"][task]["samples"]]

    def of(name, task=None):
        return [r for r in reqs if r["run"] == name
                and task in (None, r["task"])]

    def tokens(name, task):
        return [r["tokens"] for r in of(name, task)]

    bad = [f"{n} ran {len(of(n))} generate requests" for n in runs
           if len(of(n)) != limit * len(gen_tasks)]
    if bad:
        raise AssertionError(f"[harness] {bad}")
    # responses and, below the byte tokenizer's lossy decode (every id
    # past 258 prints as one character), the committed token ids
    for t in gen_tasks:
        if responses("A", t) != responses("D", t) \
                or tokens("A", t) != tokens("D", t):
            bad.append(f"A != D (null draft) on {t}")
        if responses("C", t) != responses("A", t) \
                or tokens("C", t) != tokens("A", t):
            bad.append(f"C != A on {t}")
        for x, y, r in zip(responses("A", t), responses("B", t),
                           of("B", t)):
            if x != y and r["split"] is None:
                bad.append(f"A's response != B's, their tokens equal, {t}")
    # A against B: token ids equal up to the first split, and a split
    # only where the target's logits of the two tokens tie within the
    # rounding noise of the card's bf16 (``split_ok``)
    ties = [r["split"] for r in of("B") if r["split"] is not None]
    if not all(split_ok(s, tie) for s in ties):
        bad.append(f"A != B at a split that is no rounding tie: {ties}")
    if "ai2d_ppl" in tasks:
        for name in ("B", "C"):
            if responses(name, "ai2d_ppl") != responses("A", "ai2d_ppl"):
                bad.append(f"{name}'s loglikelihoods != A's (bitwise)")
    c_scores = [r for r in scores if r["run"] == "C"]
    if any(r["again"] != r["out"] for r in c_scores):
        bad.append("score is not bitwise repeatable")
    worst = max((abs(r["out"][0] - r["plain"][0])
                 / max(1.0, abs(r["plain"][0])) for r in c_scores),
                default=0.0)
    if worst > 1e-4 or any(r["out"][1] != r["plain"][1] for r in c_scores):
        bad.append(f"score != its plain recompute (worst relative "
                   f"{worst:.3e} against 1e-4, or a greedy flag)")
    # the online calibration phases of A and C's skip_to_test, from the
    # requests' modes, the pickle and the log files
    half = int(limit * 0.5)
    a_first = [r["mode"] for r in of("A", gen_tasks[0])]
    collected = sum(r.get("rows", 0) for r in of("A"))
    written = {}
    for fname in ("acceptance_rate.json", "calibration_data.json"):
        path = os.path.join(logdir, fname)
        if os.path.exists(path):
            with open(path) as f:
                written[fname] = json.load(f)
    logged = len(written["calibration_data.json"]["candidates"]["token"]) \
        if "calibration_data.json" in written else 0
    phases_ok = (
        a_first == ["collect"] * half + ["calibrated"] * (limit - half)
        and all(r["mode"] == "calibrated" for r in of("C") + [
            r for r in of("A") if r["task"] != gen_tasks[0]])
        and digest.get("A") is not None
        and digest.get("A") == digest.get("C")
        and len(written) == 2 and collected > 0 and logged == collected)
    if not phases_ok:
        bad.append(f"online calibration phases: A's first task {a_first}, "
                   f"rows collected {collected}, logged {logged}, pickle "
                   f"after {sorted(digest)}, files {sorted(written)}")
    # K1: the AR baseline only, layers x AR steps run
    layers = reqs[0]["layers"]
    b_caps = sum(r["captured"] for r in of("B"))
    k1_want = layers * (out["B"]["ar_steps"] + WARMUP_STEPS * b_caps) \
        if on_card else 0
    if out["B"]["launches"] != k1_want or any(
            out[n]["launches"] for n in ("A", "C", "D")):
        bad.append(f"K1 launches {[out[n]['launches'] for n in runs]}, "
                   f"want [0, {k1_want}, 0, 0]")
    # captures: only at the first request of a combination in a run
    seen, late = set(), []
    for r in reqs:
        k = (r["run"],) + r["key"]
        if k in seen and r["captured"]:
            late.append((r["run"], r["task"], r["mode"]))
        seen.add(k)
    if late:
        bad.append(f"graphs captured inside later requests: {late}")
    greedy = [r["greedy"] for r in of("B")]
    if not on_card and not all(greedy):
        bad.append("B's responses do not score as greedy (fp32)")
    if bad:
        raise AssertionError(f"[harness] {bad}")

    def ms_per_token(name):
        rs = of(name)
        return 1e3 * sum(r["t"][1] - r["t"][0] for r in rs) \
            / max(1, sum(r["n"] for r in rs))

    spans = {}
    for r in reqs + scores:
        lo, hi = spans.get((r["run"], r["task"]), r["t"])
        spans[(r["run"], r["task"])] = (min(lo, r["t"][0]),
                                        max(hi, r["t"][1]))
    margins = np.asarray([m for r in of("B") for m in r["margins"]])
    ppl = [r for r in scores if r["run"] == "B"]
    out.update(
        launches=out["B"]["launches"], ar_steps=out["B"]["ar_steps"],
        ar_captures=b_caps, worst_score_rel=worst,
        agree={t: sum(r["split"] is None for r in of("B", t))
               for t in gen_tasks},
        same_text={t: sum(x == y for x, y in zip(responses("A", t),
                                                 responses("B", t)))
                   for t in gen_tasks},
        ties=ties, k1_check=sum(r["k1_check"] for r in of("B")),
        margin_median=float(np.median(margins)),
        near_ties=int((margins <= HARNESS_TIE).sum()),
        greedy_share=sum(greedy) / max(1, len(greedy)),
        ppl_greedy_share=sum(r["out"][1] for r in ppl) / max(1, len(ppl)),
        ms_token={n: ms_per_token(n) for n in ("A", "B", "D")},
        alpha=out["A"]["payload"]["msd_stats"]["avg_accept_len"],
        task_s={k: hi - lo for k, (lo, hi) in spans.items()},
        peak=torch.cuda.max_memory_allocated() if on_card else 0,
        seconds=time.perf_counter() - t_phase)
    log(f"[harness] runs A (calibrated MSD), B (AR), C (skip_to_test), D "
        f"(null draft) through harness.__main__.main, {limit} synthetic "
        f"docs per task, {max_new} new tokens: "
        + "; ".join(f"{n} {out[n]['s']:.1f}s" for n in runs) + f" on {card}")
    log("[harness] seconds per task (first request's start to last's "
        "end): " + "; ".join(
            f"{r}/{t} {s:.2f}" for (r, t), s in out["task_s"].items())
        + f" (C's ai2d_ppl includes each score's repeat and recompute) on "
        f"{card}")
    log(f"[harness] A == D (null draft) and C == A on {gen_tasks}, "
        f"responses and token ids: True; A collected {collected} rows on "
        f"docs 0-{half - 1} of {gen_tasks[0]} and decoded from doc {half} "
        f"calibrated, later tasks and C from the pickle; ai2d_ppl "
        f"loglikelihoods A == B == C bitwise, repeat bitwise, plain "
        f"recompute (unpadded) worst relative {worst:.3e} (limit 1e-4) on "
        f"{card}")
    log(f"[harness] A == B: token ids equal in {out['agree']} of {limit} "
        f"requests per task, responses in {out['same_text']}; each other "
        f"request splits at a rounding tie (split_ok, {HARNESS_TIE} bf16 "
        f"ulps plus the row's noise): "
        + ("; ".join(split_text(s) for s in ties) or "none")
        + f" (K1 launches of the checks, after B's count was read: "
        f"{out['k1_check']}); top-1 minus top-2 over B's {len(margins)} tokens: median "
        f"{out['margin_median']:.2f} ulps, {out['near_ties']} within "
        f"{HARNESS_TIE} on {card}")
    log(f"[harness] ms per generated token (prefill included): A "
        f"{out['ms_token']['A']:.2f}, B {out['ms_token']['B']:.2f}, D "
        f"{out['ms_token']['D']:.2f}; A's avg_accept_len "
        f"{out['alpha']:.3f}; B's own responses score greedy: "
        f"{sum(greedy)}/{len(greedy)}; ai2d_ppl continuations greedy: "
        f"{out['ppl_greedy_share']:.3f}; K1 launches in B {out['launches']}"
        f" = {layers} x ({out['ar_steps']} AR tokens decoded + "
        f"{WARMUP_STEPS} warm-up steps x {b_caps} capture), 0 in A, C, D; "
        f"peak {out['peak'] / 2**30:.2f} GiB allocated; phase "
        f"{out['seconds']:.1f}s on {card}")
    return out


def split_text(s: dict) -> str:
    """One ``split_record`` for a log line."""
    text = (f"token {s['at']}, gap {s['gap']:.4f} = {s['ulps']:.1f} ulps "
            f"at |logit| {s['logit']:.4f} (noise {s['noise']:.1f}), ranks "
            f"{s['ranks']}")
    if "k1" in s:
        k = s["k1"]
        text += (f", K1 row: picks AR's token {k['picks_b']}, {k['calls']} "
                 f"calls within TOL of the twin {k['within']} (excess "
                 f"{k['excess']:.3e}), {k['dev']:.1f} ulps off the twin's "
                 f"row")
    return text


def judge_reply(prompt: str) -> str:
    """The loopback judge's fixed reply to ``prompt`` (``JUDGE_REPLIES``
    by marker; "ok" to anything else)."""
    return next((r for m, r in JUDGE_REPLIES if m in prompt), "ok")


@contextlib.contextmanager
def judge_stub(reply=judge_reply):
    """A judge endpoint on a free loopback port, served by a thread until
    the block ends: each POST is answered with ``reply(prompt)`` of its
    last message (a str goes out in the OpenAI chat contract, bytes as the
    body itself). Yields (url, calls): each request's JSON body, in
    order."""
    import threading
    from http.server import BaseHTTPRequestHandler, HTTPServer

    calls = []

    class Handler(BaseHTTPRequestHandler):
        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            body = json.loads(self.rfile.read(n).decode())
            calls.append(body)
            out = reply(body["messages"][-1]["content"])
            if isinstance(out, str):
                out = json.dumps({"choices": [
                    {"message": {"content": out}}]}).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(out)))
            self.end_headers()
            self.wfile.write(out)

        def log_message(self, *a):
            pass

    srv = HTTPServer(("127.0.0.1", 0), Handler)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    try:
        yield f"http://127.0.0.1:{srv.server_port}/v1/chat/completions", calls
    finally:
        srv.shutdown()
        srv.server_close()
        th.join(timeout=30)


def dead_judge_url() -> str:
    """A judge URL on a loopback port that nothing listens on (bound,
    read and released)."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    return f"http://127.0.0.1:{port}/v1/chat/completions"


YAML_UTILS = '''"""Hooks of the smoke's YAML task (the lmms-eval tasks/<name>/utils.py
convention): a seeded 336px image per doc and the prompt's kwargs."""
import numpy as np


def doc_to_visual(doc):
    rng = np.random.default_rng(doc["seed"])
    return [rng.integers(0, 255, size=(336, 336, 3), dtype=np.uint8)]


def doc_to_text(doc, lmms_eval_specific_kwargs):
    kw = lmms_eval_specific_kwargs
    return f"{kw['pre_prompt']}{doc['question']}{kw['post_prompt']}"
'''

YAML_TASK = '''task: "{name}"
dataset_path: "{docs}"
test_split: test
output_type: generate_until
doc_to_visual: !function smoke_utils.doc_to_visual
doc_to_text: !function smoke_utils.doc_to_text
doc_to_target: "answer"
generation_kwargs:
  max_new_tokens: 8
  temperature: 0
  do_sample: False
metric_list:
  - metric: exact_match
    aggregation: mean
lmms_eval_specific_kwargs:
  default:
    pre_prompt: ""
    post_prompt: "\\nAnswer the question using a single word or phrase."
'''


def write_yaml_task(path: str, n: int) -> str:
    """A YAML task directory (lmms-eval's file format: the YAML, its
    ``!function`` hooks in ``smoke_utils.py`` beside it, ``n`` docs in a
    JSON file) registering ``HARNESS_EXT_YAML``; returns the directory."""
    os.makedirs(path, exist_ok=True)
    docs = os.path.join(path, "docs.json")
    with open(docs, "w") as f:
        json.dump([{"question": f"What color is the patch in region {i}?",
                    "answer": "red", "seed": 40 + i} for i in range(n)], f)
    with open(os.path.join(path, "smoke_utils.py"), "w") as f:
        f.write(YAML_UTILS)
    with open(os.path.join(path, "smoke_vqa.yaml"), "w") as f:
        f.write(YAML_TASK.format(name=HARNESS_EXT_YAML, docs=docs))
    return path


def run_harness_ext(res, ckpt: str, draft_dir: str, root: str,
                    limit: int = HARNESS_EXT_LIMIT,
                    max_new: int = HARNESS_NEW, stub_reply=judge_reply
                    ) -> dict:
    """The extended eval tier through the harness CLI's
    ``msd_tpu_torch.harness.__main__.main(argv)``, in process, after
    ``run_harness`` on the same checkpoint (``ckpt``, the medusa draft in
    ``draft_dir``, the null draft and the calibrator pickle it left under
    ``root``): ``HARNESS_EXT_TASKS`` and a YAML task written to ``root``
    and registered by ``--include_path``, ``limit`` docs each, ``max_new``
    new tokens per request (each round of a multi-round doc is one),
    ``--judge endpoint:URL`` at a loopback stub (``judge_stub``) that
    answers each prompt with ``stub_reply`` (``judge_reply`` unless a test
    plants another):

    C. ``llava_msd_calibrated --use_msd --use_calibration`` reading
       ``[harness]``'s pickle (skip_to_test);
    B. ``llava``: the AR baseline;
    D. ``llava_msd`` with the null draft on the generation tasks;
    F. C on ``HARNESS_EXT_JUDGED`` with the judge at a dead loopback
       port (the planted fault: a judge that never answers).

    Requests are recorded by ``record_harness``. Fails unless: each run made
    one request per doc and round, and each doc of a multi-round task ran
    its ``HARNESS_EXT_ROUNDS``; C's responses and token ids == D's, and F's
    == C's on its tasks; C's token ids == B's on the same prompt up to each
    request's first split, a rounding tie (``split_ok`` of
    ``split_record`` at ``HARNESS_TIE``, as in ``run_harness``; none off
    the card), or up to where C reached MSD's step limit (at a prompt
    truncated to the budget: both packages stop MSD a tree and a path below
    max_seq_len, AR 2 rows below it), and a multi-round doc's later rounds,
    whose prompts hold the differing responses, are not compared
    (``ar_against_msd``); mmlu's loglikelihoods are bitwise
    equal in C and B, repeat bitwise and lie within 1e-4 x max(1, |lp|) of
    ``plain_score`` with its greedy flag; every C and F request decodes
    calibrated (a multi-round task's rounds: plain MSD, the adapter's round
    path) and the pickle is left as it was; K1 launches 0 in C, D and F and,
    in each request of B, layers x (its AR tokens decoded + the warm-up
    steps of each AR-token capture); no capture after a combination's first
    request; the YAML task loaded its JSON docs (not synthetic ones) in C, B
    and D; ifeval's per-instruction strict and loose results and its
    aggregate equal what ``task_utils.ifeval.evaluate`` gives on the logged
    responses; the stub served each run of C, B and D exactly the judge
    calls its scorers make and nothing during F, and each score (per doc and
    aggregated) is what the scorers give when an in-process judge answers by
    ``judge_reply`` (for F: with no judge): llava_in_the_wild at the reply's
    6 / 8 = 75.0, each mmbench doc a hit iff its inferred option, else the
    reply's "A", is its gold, each mmvetv2 doc 0.5, each wildvision doc the
    verdict B>A (raw 1, a win), each live_bench doc with a response the
    rating 7; F's judged scores differ from C's (mmbench's may agree: its
    offline rule settles an inferable option)."""
    import hashlib
    import io

    import torch
    from msd_tpu_torch.engine.graphs import WARMUP_STEPS
    from msd_tpu_torch.harness import __main__ as HM
    from msd_tpu_torch.harness import judge as J
    from msd_tpu_torch.harness.registry import get_task
    from msd_tpu_torch.harness.task_utils import ifeval as IF
    from msd_tpu_torch.harness.tasks_mmbench import _options, can_infer
    from msd_tpu_torch.ops import decode_attention as K1

    ctx = res["ctx"]
    device, on_card, sync = ctx["device"], ctx["on_card"], ctx["sync"]
    card = smi_name_and_limit() if on_card else "cpu"
    tie = HARNESS_TIE if on_card else 0.0
    t_phase = time.perf_counter()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    pkl, null_dir = f"{root}/harness/calibrator.pkl", f"{root}/null"

    def digest():
        with open(pkl, "rb") as f:
            return hashlib.sha256(f.read()).hexdigest()

    pkl_digest = digest()
    ydir = write_yaml_task(os.path.join(root, "harness_ext"), limit)
    every = list(HARNESS_EXT_TASKS) + [HARNESS_EXT_YAML]
    gen_every = [t for t in every if t != "mmlu"]
    margs = (f"pretrained={ckpt},"
             f"max_seq_len={ctx['gens']['graph'].eng.max_seq_len}")
    msd = ["--model", "llava_msd_calibrated", "--use_msd",
           "--use_calibration", "--msd_model_path", draft_dir,
           "--model_args", f"{margs},calibrator_path={pkl}"]
    runs = {
        "C": msd + ["--tasks", ",".join(every)],
        "B": ["--model", "llava", "--model_args", margs, "--msd_model_path",
              draft_dir, "--tasks", ",".join(every)],
        "D": ["--model", "llava_msd", "--use_msd", "--model_args", margs,
              "--msd_model_path", null_dir, "--tasks", ",".join(gen_every)],
        "F": msd + ["--tasks", ",".join(HARNESS_EXT_JUDGED)],
    }
    gen_of = {n: [t for t in a[a.index("--tasks") + 1].split(",")
                  if t != "mmlu"] for n, a in runs.items()}
    # the task of each generate request of a run: a doc of a multi-round
    # task makes one per round
    seq = {n: [t for t in ts
               for _ in range(limit * HARNESS_EXT_ROUNDS.get(t, 1))]
           for n, ts in gen_of.items()}
    common = ["--device", str(device), "--limit", str(limit),
              "--gen_kwargs", f"max_new_tokens={max_new}", "--log_samples",
              "--include_path", ydir]
    run, out = [None], {"card": card}
    # B against C's request of the same index
    try:
        with record_harness(sync, run,
                            lambda n, k: seq[n][k] if k < len(seq[n])
                            else None, "C", "mmlu", tie=tie) as (
                reqs, scores, ar_steps, settle), \
                judge_stub(stub_reply) as (url, calls):
            for name, argv in runs.items():
                run[0] = name
                steps0, calls0 = ar_steps[0], len(calls)
                judge = dead_judge_url() if name == "F" else url
                # K1's count over this run: zeroed just before, read just
                # after
                K1.decode_attention.launches = 0
                t1 = time.perf_counter()
                with contextlib.redirect_stdout(io.StringIO()):
                    payload = HM.main(argv + common
                                      + ["--judge", f"endpoint:{judge}"])
                sync()
                out[name] = {"payload": payload,
                             "s": time.perf_counter() - t1,
                             "launches": K1.decode_attention.launches,
                             "ar_steps": ar_steps[0] - steps0,
                             "calls": calls[calls0:]}
                # the AR requests' split checks, after the count is read
                settle()
                gc.collect()
                if on_card:
                    torch.cuda.empty_cache()
    finally:
        J.set_judge(None)

    def samples(name, task):
        return out[name]["payload"]["details"][task]["samples"]

    def responses(name, task):
        return [s["response"] for s in samples(name, task)]

    def of(name, task=None):
        return [r for r in reqs if r["run"] == name
                and task in (None, r["task"])]

    def tokens(name, task):
        return [r["tokens"] for r in of(name, task)]

    bad = [f"{n} ran {len(of(n))} generate requests, want {len(seq[n])}"
           for n in runs if len(of(n)) != len(seq[n])]
    bad += [f"{n}: a doc of {t} ran {len(r) if isinstance(r, list) else 1}"
            f" rounds, want {k}" for n in runs
            for t, k in HARNESS_EXT_ROUNDS.items() if t in gen_of[n]
            for r in responses(n, t) if not (isinstance(r, list)
                                             and len(r) == k)]
    if bad:
        raise AssertionError(f"[harness_ext] {bad}")
    for t in gen_of["D"]:
        if responses("C", t) != responses("D", t) \
                or tokens("C", t) != tokens("D", t):
            bad.append(f"C != D (null draft) on {t}")
    for t in gen_of["F"]:
        if responses("F", t) != responses("C", t) \
                or tokens("F", t) != tokens("C", t):
            bad.append(f"F != C on {t}")
    compared, stops, ties, mismatch = ar_against_msd(
        {t: (of("C", t), responses("C", t)) for t in gen_of["B"]},
        {t: (of("B", t), responses("B", t)) for t in gen_of["B"]}, tie)
    bad += mismatch
    if responses("B", "mmlu") != responses("C", "mmlu"):
        bad.append("mmlu's loglikelihoods: B != C (bitwise)")
    c_scores = [r for r in scores if r["run"] == "C"]
    if len(c_scores) != 4 * limit \
            or any(r["again"] != r["out"] for r in c_scores):
        bad.append(f"{len(c_scores)} mmlu scores in C, or one not bitwise "
                   f"repeatable")
    worst = max((abs(r["out"][0] - r["plain"][0])
                 / max(1.0, abs(r["plain"][0])) for r in c_scores),
                default=0.0)
    if worst > 1e-4 or any(r["out"][1] != r["plain"][1] for r in c_scores):
        bad.append(f"mmlu score != its plain recompute (worst relative "
                   f"{worst:.3e} against 1e-4, or a greedy flag)")
    if any(r["mode"] != ("msd" if r["task"] in HARNESS_EXT_ROUNDS
                         else "calibrated") for r in of("C") + of("F")) \
            or digest() != pkl_digest:
        bad.append("C or F did not decode calibrated from [harness]'s "
                   "pickle (a multi-round task: plain MSD), or the pickle "
                   "changed")
    layers = reqs[0]["layers"]
    b_caps = sum(r["captured"] for r in of("B"))
    k1_want = layers * (out["B"]["ar_steps"] + WARMUP_STEPS * b_caps) \
        if on_card else 0
    if out["B"]["launches"] != k1_want or any(
            out[n]["launches"] for n in ("C", "D", "F")):
        bad.append(f"K1 launches {[out[n]['launches'] for n in runs]}, "
                   f"want [0, {k1_want}, 0, 0]")
    k1_off = [(r["task"], r["k1"]) for r in of("B") if r["k1"] != (
        layers * (r["ar_steps"] + WARMUP_STEPS * r["captured"])
        if on_card else 0)]
    if k1_off:
        bad.append(f"B's requests' K1 launches != layers x (AR tokens + "
                   f"warm-up steps): {k1_off}")
    seen, late = set(), []
    for r in reqs:
        k = (r["run"],) + r["key"]
        if k in seen and r["captured"]:
            late.append((r["run"], r["task"], r["mode"]))
        seen.add(k)
    if late:
        bad.append(f"graphs captured inside later requests: {late}")
    greedy = [r["greedy"] for r in of("B")]
    if not on_card and not all(greedy):
        bad.append("B's responses do not score as greedy (fp32)")
    for n in ("C", "B", "D"):
        pl = out[n]["payload"]
        if HARNESS_EXT_YAML in pl.get("synthetic_tasks", ()) \
                or len(samples(n, HARNESS_EXT_YAML)) != limit \
                or "exact_match" not in pl["results"][HARNESS_EXT_YAML]:
            bad.append(f"{n}: the YAML task's docs or metrics "
                       f"{pl['results'].get(HARNESS_EXT_YAML)}")

    # IFEval: each instruction's strict and loose result, recomputed by the
    # checkers from the logged response, and the aggregates over them
    ifeval = {}
    for n in ("C", "B", "D"):
        strict, loose, p_strict, p_loose = [], [], [], []
        for d, s in zip(get_task("ifeval").load_docs(limit=limit),
                        samples(n, "ifeval")):
            a, b = IF.evaluate(list(d["instruction_id_list"]),
                               list(d["kwargs"]), s["response"],
                               prompt=d["prompt"])
            if [float(x) for x in a] != s["scores"]["_inst_strict"] \
                    or [float(x) for x in b] != s["scores"]["_inst_loose"]:
                bad.append(f"{n}: an ifeval doc's instruction results != "
                           f"the checkers' on its response")
            strict += a
            loose += b
            p_strict.append(float(all(a)))
            p_loose.append(float(all(b)))
        got = out[n]["payload"]["results"]["ifeval"]
        want = {"prompt_level_strict_acc": float(np.mean(p_strict)),
                "prompt_level_loose_acc": float(np.mean(p_loose)),
                "inst_level_strict_acc": float(np.mean(strict)),
                "inst_level_loose_acc": float(np.mean(loose))}
        if {k: got.get(k) for k in want} != want:
            bad.append(f"{n}: ifeval's aggregate {got} != the checkers' "
                       f"{want}")
        ifeval[n] = want

    # the judge: the calls and scores the same scorers give when an
    # in-process judge answers by the rule (F: with no judge)
    class Replay:
        def __init__(self):
            self.calls = []

        def complete(self, prompt, max_tokens=256, temperature=0.0,
                     system=None):
            self.calls.append((system, prompt, max_tokens, temperature))
            return judge_reply(prompt)

    def replay(name, judge):
        J.set_judge(judge)
        try:
            got = {}
            for t in HARNESS_EXT_JUDGED:
                task = get_task(t)
                rows = [task.process_results(d, [r]) for d, r in zip(
                    task.load_docs(limit=limit), responses(name, t))]
                got[t] = (rows, task.aggregate(rows))
            return got
        finally:
            J.set_judge(None)

    def served(body):
        m = body["messages"]
        return (m[0]["content"] if len(m) == 2 else None, m[-1]["content"],
                body["max_tokens"], body["temperature"])

    # each judged doc's score under the stub's replies
    stub_rule = {
        "mmvetv2": lambda r, row: row["gpt_eval_score"] == 0.5,
        "wildvision_0617": lambda r, row: (row["raw_score"], row["win"])
        == (1.0, 1.0),
        "live_bench": lambda r, row: row["gpt4_eval_score"]
        == (7.0 if r else 0.0),
    }
    judged_rows = {}
    for n in runs:
        rp = Replay() if n != "F" else None
        want = replay(n, rp)
        judged_rows[n] = {t: [s["scores"] for s in samples(n, t)]
                          for t in HARNESS_EXT_JUDGED}
        if [served(b) for b in out[n]["calls"]] != (rp.calls if rp else []):
            bad.append(f"{n}: the stub served {len(out[n]['calls'])} calls,"
                       f" the scorers make {len(rp.calls) if rp else 0}")
        for t, (rows, agg) in want.items():
            if judged_rows[n][t] != rows \
                    or out[n]["payload"]["results"][t] != agg:
                bad.append(f"{n}: {t}'s scores != the rule's for the "
                           f"judge's replies")
        if n == "F":
            continue
        if out[n]["payload"]["results"]["llava_in_the_wild"][
                "gpt_eval_llava_all"] != 75.0:
            bad.append(f"{n}: llava_in_the_wild's score != 6 / 8 = 75.0")
        mm = get_task("mmbench_en_dev")
        for d, r, row in zip(mm.load_docs(limit=limit),
                             responses(n, "mmbench_en_dev"),
                             judged_rows[n]["mmbench_en_dev"]):
            hit = (can_infer(r, _options(d)) or "A") == d["answer"]
            if row["_hit"] != float(hit):
                bad.append(f"{n}: an mmbench doc's hit != the rule's")
        for t, ok in stub_rule.items():
            if not all(ok(r, row) for r, row in zip(responses(n, t),
                                                    judged_rows[n][t])):
                bad.append(f"{n}: {t}'s scores != the stub's replies'")
    judged_res = {n: {t: out[n]["payload"]["results"][t]
                      for t in HARNESS_EXT_JUDGED} for n in ("C", "F")}
    same = [t for t in HARNESS_EXT_JUDGED if t != "mmbench_en_dev"
            and judged_res["F"][t] == judged_res["C"][t]]
    if same:
        bad.append(f"F (dead judge) scored as C (judged) on {same}")
    if bad:
        raise AssertionError(f"[harness_ext] {bad}")

    def ms_per_token(rs):
        return 1e3 * sum(r["t"][1] - r["t"][0] for r in rs) \
            / max(1, sum(r["n"] for r in rs))

    spans = {}
    for r in reqs + scores:
        lo, hi = spans.get((r["run"], r["task"]), r["t"])
        spans[(r["run"], r["task"])] = (min(lo, r["t"][0]),
                                        max(hi, r["t"][1]))
    out.update(
        launches=out["B"]["launches"], ar_steps=out["B"]["ar_steps"],
        ar_captures=b_caps, worst_score_rel=worst,
        agree={t: sum(r["split"] is None for r in compared
                      if r["task"] == t) for t in gen_of["B"]},
        ties=ties, budget_stops=stops,
        k1_check=sum(r["k1_check"] for r in of("B")),
        calls={n: len(out[n]["calls"]) for n in runs},
        greedy_share=sum(greedy) / max(1, len(greedy)),
        judged=judged_res, ifeval=ifeval,
        ms_token={n: ms_per_token(of(n)) for n in runs},
        task_s={k: hi - lo for k, (lo, hi) in spans.items()},
        task_ms_token={(n, t): ms_per_token(of(n, t)) for n in runs
                       for t in gen_of[n]},
        k1_by_task={t: sum(r["k1"] for r in of("B", t))
                    for t in gen_of["B"]},
        peak=torch.cuda.max_memory_allocated() if on_card else 0,
        seconds=time.perf_counter() - t_phase)
    log(f"[harness_ext] runs C (calibrated MSD, skip_to_test), B (AR), D "
        f"(null draft), F (C with a dead judge) through harness.__main__."
        f"main, {limit} docs of {', '.join(every)}, {max_new} new tokens, "
        f"the judge at a loopback stub: "
        + "; ".join(f"{n} {out[n]['s']:.1f}s" for n in runs)
        + "; ms per generated token (prefill included) "
        + ", ".join(f"{n} {v:.2f}" for n, v in out["ms_token"].items())
        + f" on {card}")
    for t in every:
        log(f"[harness_ext] {t}: " + "; ".join(
            f"{n} {out['task_s'][(n, t)]:.2f}s"
            + (f", {out['task_ms_token'][(n, t)]:.2f} ms/token"
               if (n, t) in out["task_ms_token"] else "")
            for n in runs if (n, t) in out["task_s"])
            + (f"; K1 in B {out['k1_by_task'][t]}"
               if t in out["k1_by_task"] else "") + f" on {card}")
    log(f"[harness_ext] C == D and F == C, responses and token ids: True; "
        f"C == B token ids in {out['agree']} of the requests compared per "
        f"task ({limit} docs, a multi-round doc's rounds up to its first "
        f"split), each other split a rounding tie (split_ok, {HARNESS_TIE} "
        f"bf16 ulps plus the row's noise): "
        + ("; ".join(f"{s['task']} {split_text(s)}" for s in ties)
           or "none")
        + f" (K1 launches of the checks, after B's count was read: "
        f"{out['k1_check']})"
        + f"; C stopped at MSD's step limit, its tokens a prefix of B's "
        f"(task, tokens, room): {stops or 'none'}; rounds per multi-round "
        f"doc {HARNESS_EXT_ROUNDS}; ifeval "
        f"recomputed by the checkers {out['ifeval']}; mmlu C == B bitwise,"
        f" repeat bitwise, plain recompute worst relative {worst:.3e}; "
        f"judge calls served {out['calls']}, each as the scorers make "
        f"them; judged scores C {out['judged']['C']}, F (dead judge, "
        f"offline rules) {out['judged']['F']}; K1 launches in B "
        f"{out['launches']} = {layers} x ({out['ar_steps']} AR tokens + "
        f"{WARMUP_STEPS} warm-up steps x {b_caps} captures), by task "
        f"{out['k1_by_task']}, 0 in C, D, F; peak "
        f"{out['peak'] / 2**30:.2f} GiB; phase {out['seconds']:.1f}s on "
        f"{card}")
    return out


def budget_stop(c: dict, b: dict) -> bool:
    """Whether MSD's request ``c`` stopped at its step limit with its
    tokens a prefix of AR's request ``b`` of the same prompt (records of
    ``record_harness``): B's split lies at C's last token and C committed
    ``room`` tokens or more. MSD's step limit keeps a tree and a path
    below max_seq_len, AR's does not (both packages), so at a prompt
    truncated to the budget C stops first."""
    return b["split"] is not None and b["split"]["at"] == c["n"] >= c["room"]


def ar_against_msd(msd: dict, ar: dict, tie: float) -> tuple:
    """MSD's requests and responses beside AR's, task by task (``msd`` and
    ``ar``: {task: (records of ``record_harness``, responses)}, a
    multi-round task's docs ``HARNESS_EXT_ROUNDS`` records each), doc by
    doc and round by round while their prompts agree: a round's prompt
    holds the earlier rounds' responses, so a doc is compared up to its
    first split. A request that stopped at MSD's step limit
    (``budget_stop``) is set apart; each other split must pass
    ``split_ok`` at ``tie``. Returns (AR records compared, budget stops
    (task, tokens, room), splits compared, faults)."""
    compared, stops, bad = [], [], []
    for t, (bs, b_resp) in ar.items():
        k = HARNESS_EXT_ROUNDS.get(t, 1)
        cs, c_resp = msd[t]
        for i, resp in enumerate(b_resp):
            split = False
            for c, b in zip(cs[i * k:(i + 1) * k], bs[i * k:(i + 1) * k]):
                if c["prompt"] != b["prompt"]:
                    bad.append(f"B's prompt != C's before a split, {t}")
                if budget_stop(c, b):
                    stops.append((t, c["n"], c["room"]))
                else:
                    compared.append(b)
                if b["split"] is not None:
                    split = True
                    break
            if resp != c_resp[i] and not split:
                bad.append(f"C's response != B's, their tokens equal, {t}")
    ties = [dict(r["split"], task=r["task"]) for r in compared
            if r["split"] is not None]
    if not all(split_ok(s, tie) for s in ties):
        bad.append(f"C != B at a split that is no rounding tie: {ties}")
    return compared, stops, ties, bad


def _weight_bytes(tree) -> int:
    return sum(t.numel() * t.element_size()
               for t in _flat_tensors(tree).values())


def _quant_runs(label, tp, drafts, tcfg, dcfg, eng, sp, ids, feats, max_new,
                warm, widths, device, on_card, sync, e0,
                want_tokens=None) -> dict:
    """One weight combination on one prompt: graph MSD with the main
    draft, with the null draft, the AR baseline from the shared prefill,
    eager MSD and the oracle draft on a generator of its own. Raises
    unless MSD == the null-draft tokens == eager MSD (== ``want_tokens``
    when given), the oracle is accepted to full depth, and the AR request
    launches K1 layers x AR tokens decoded times. Returns the timings."""
    import torch
    from msd_tpu_torch.engine.generator import MSDGenerator
    from msd_tpu_torch.ops import decode_attention as K1

    def make(graphs):
        return MSDGenerator(tp, drafts["msd"], tcfg, dcfg, eng,
                            n_img=len(feats), eos_id=-1, sp=sp,
                            device=device, cuda_graphs=graphs)

    if on_card:
        torch.cuda.reset_peak_memory_stats()
    gen, eager = make(True), make(False)
    gen.naive_generate(ids, feats, warm, share_prefill=True)
    for name in ("null", "msd"):
        gen.params["draft"] = drafts[name]
        gen.generate(ids, feats, warm)
    sync()
    caps = len(gen.graphs.steps) if gen.graphs is not None else 0
    runs, secs = {}, {}
    K1.decode_attention.launches = 0
    for name in ("ar", "msd", "null"):
        gen.params["draft"] = drafts["msd" if name == "ar" else name]
        t1 = time.perf_counter()
        runs[name] = gen.naive_generate(ids, feats, max_new,
                                        share_prefill=True) \
            if name == "ar" else gen.generate(ids, feats, max_new)
        sync()
        secs[name] = time.perf_counter() - t1
    launches = K1.decode_attention.launches
    gen.params["draft"] = drafts["msd"]
    runs["eager"] = eager.generate(ids, feats, max_new)
    if gen.graphs is not None and len(gen.graphs.steps) != caps:
        raise AssertionError(f"[quant] {label}: a capture in a timed run")
    decoded = len(runs["ar"].tokens) - 1
    k1_want = tcfg.num_hidden_layers * decoded if on_card else 0
    msd = runs["msd"].tokens
    same = {"MSD == null draft": np.array_equal(msd, runs["null"].tokens),
            "graph == eager": np.array_equal(msd, runs["eager"].tokens)}
    if want_tokens is not None:
        same["== the unquantized draft"] = np.array_equal(msd, want_tokens)
    # the oracle draft, on a generator that captures inside the block
    steps_want, hist_want = oracle_schedule(len(widths), max_new)
    ref = torch.from_numpy(runs["null"].tokens.astype(np.int32)).to(device)
    oracle = make(True)
    with oracle_draft(ref, e0):
        r = oracle.generate(ids, feats, max_new)
    full = min(len(widths) + 1, 15)
    same["oracle accepted to full depth"] = bool(
        np.array_equal(r.tokens, runs["null"].tokens)
        and r.accept_steps == steps_want
        and r.alpha_hist[full] == hist_want[full])
    out = {"launches": launches, "same": same,
           "ar_ms": secs["ar"] * 1e3 / len(runs["ar"].tokens),
           "msd_ms_step": secs["msd"] * 1e3 / runs["msd"].accept_steps,
           "alpha": runs["msd"].avg_accept_len,
           "bytes": _weight_bytes(tp) + _weight_bytes(drafts["msd"])}
    if on_card:
        out["ar_replay_ms"] = _replay_ms(gen, runs["ar"].graph)
        out["step_replay_ms"] = _replay_ms(gen, runs["msd"].graph)
        out["peak"] = torch.cuda.max_memory_allocated()
    else:
        out["ar_replay_ms"] = out["step_replay_ms"] = float("nan")
        out["peak"] = 0
    log(f"[quant] {label}: {same}; AR {out['ar_ms']:.2f} ms/token wall "
        f"incl. prefill, {out['ar_replay_ms']:.3f} ms per replayed AR "
        f"token; MSD {out['msd_ms_step']:.2f} ms/step wall incl. prefill, "
        f"{out['step_replay_ms']:.3f} ms per replayed step, alpha "
        f"{out['alpha']:.3f}; K1 launches {launches}, expected {k1_want} "
        f"(= {tcfg.num_hidden_layers} layers x {decoded} AR tokens "
        f"decoded); weights {out['bytes'] / 1e9:.2f} GB, peak "
        f"{out['peak'] / 2**30:.2f} GiB allocated")
    if not all(same.values()) or launches != k1_want:
        raise AssertionError(f"[quant] {label}: {same}, K1 launches "
                             f"{launches} != {k1_want}")
    del gen, eager, oracle
    return out


def dequant_cost(tq: dict) -> str:
    """Device ms to dequantize every weight one AR token reads from the
    quantized target ``tq`` (each layer's seven, then lm_head), graph-
    replayed, by two stock expressions with the same bits: the port's one
    kernel (``torch.mul(w_q, scale, out=bf16)``: the product in fp32,
    rounded as it is written) and the three of ``(w_q.float() * scale)
    .to(bf16)``; with the bytes each moves and their time at the card's
    memory rate."""
    import torch
    from msd_tpu_torch.models import llama as L
    from msd_tpu_torch.ops.quant import unpack_int4

    layers = tq["layers"]
    n = layers["q_proj"].shape[0]
    names = list(L._QUANT_AXES)
    int4 = "q_proj_qs4" in layers
    sfx = "_qs4" if int4 else "_qs"

    def weights(i):
        out = [(layers[k][i], layers[k + sfx][i]) for k in names]
        if i == n - 1:
            out.append((tq["lm_head"], tq["lm_head" + sfx]))
        return out

    def one(i):
        for q, sc in weights(i):
            q = unpack_int4(q) if int4 else q
            torch.mul(q, sc, out=torch.empty(q.shape, dtype=torch.bfloat16,
                                             device=q.device))

    def three(i):
        for q, sc in weights(i):
            q = unpack_int4(q) if int4 else q
            (q.float() * sc).to(torch.bfloat16)

    elems = sum(q.numel() * (2 if int4 else 1)
                for i in range(n) for q, _ in weights(i))
    t_one, t_three = graph_ms(one, n) * n, graph_ms(three, n) * n
    b_one, b_three = 3 * elems, 11 * elems     # int8 in, bf16 (fp32) out
    return (f"dequantizing one AR token's {elems / 1e9:.2f}G weights "
            f"({'int4' if int4 else 'int8'}): one kernel {t_one:.3f} ms "
            f"({b_one / 1e9:.1f} GB, {b_one / HBM_BYTES_PER_S * 1e3:.2f} ms "
            f"at the memory rate), three kernels {t_three:.3f} ms "
            f"({b_three / 1e9:.1f} GB, "
            f"{b_three / HBM_BYTES_PER_S * 1e3:.2f} ms)")


def run_quant(res) -> dict:
    """Weight-only quantization on the main path's prompt 0 and weights:
    an int8 target, an int4 target (lm_head included), and the bf16
    target with an int8 draft (``_quant_runs`` each: MSD == null draft ==
    eager, the oracle at full depth, K1 per AR token; the int8 draft's
    tokens == the bf16 draft's, drafting being lossless); beside them the
    bf16 main path's replayed AR token and verify step."""
    import gc

    import torch
    from msd_tpu_torch.models import draft as D
    from msd_tpu_torch.models import llama as L

    ctx = res["ctx"]
    gen, drafts = ctx["gens"]["graph"], ctx["drafts"]
    on_card, sync = ctx["on_card"], ctx["sync"]
    ids, feats = ctx["prompts"][0], ctx["feats"]
    t_phase = time.perf_counter()
    tp = gen.params["target"]
    out = {}
    if on_card:
        out["bf16"] = {"ar_replay_ms": _replay_ms(
            gen, res["graph", "ar"][0].graph), "step_replay_ms": _replay_ms(
            gen, res["graph", "msd"][0].graph)}
        log(f"[quant] bf16 main path, same card: "
            f"{out['bf16']['ar_replay_ms']:.3f} ms per replayed AR token, "
            f"{out['bf16']['step_replay_ms']:.3f} ms per replayed step; "
            f"weights {(_weight_bytes(tp) + _weight_bytes(drafts['msd'])) / 1e9:.2f} GB")
    combos = (("int8 target", 8, None), ("int4 target", 4, None),
              ("int8 draft", None, 8))
    new = min(QUANT_NEW, ctx["max_new"])
    for label, tbits, dbits in combos:
        t1 = time.perf_counter()
        tq = L.quantize_llama_params(tp, True, tbits) if tbits else tp
        dq = {name: D.quantize_draft_params(drafts[name], dbits)
              if dbits else drafts[name] for name in ("msd", "null")}
        sync()
        log(f"[quant] {label}: quantized in "
            f"{time.perf_counter() - t1:.1f}s")
        if tbits and on_card:
            log(f"[quant] {label}: " + dequant_cost(tq))
        out[label] = _quant_runs(
            label, tq, dq, ctx["tcfg"], gen.dcfg, gen.eng, gen.sp, ids,
            feats, new, ctx["max_new_warm"], ctx["widths"],
            ctx["device"], on_card, sync, ctx["e0"],
            want_tokens=res["graph", "msd"][0].tokens[:new]
            if dbits else None)
        del tq, dq
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[quant] 7B phase took {out['seconds']:.1f}s")
    return out


def time_k1_row(card: str, label: str, hq: int, hkv: int, kv_len: int,
                s: int, layers: int) -> dict:
    """K1 at an AR row (T=1, ``hq`` query and ``hkv`` kv heads, bf16) at
    ``kv_len`` against its plain twin (the stated tolerance, the first
    and last cache), then in CUDA graphs over ``layers`` distinct caches
    of ``s`` rows, sized to hold more live K/V than the 50 MB L2 (each
    launch finds its cache cold, as on the AR path): kernel (twice), its
    plain twin (twice) and SDPA (``enable_gqa`` for GQA), and the bound.
    Returns the kernels line's fields for this shape (``launches`` set by
    the phase that runs it)."""
    import torch
    import torch.nn.functional as F
    from msd_tpu_torch.ops import decode_attention as K1

    bf16 = torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(hq + kv_len)
    q = torch.randn(1, hq, 128, generator=g, device="cuda").to(bf16)
    ks = torch.randn(layers, s, hkv, 128, generator=g, device="cuda",
                     dtype=bf16)
    vs = torch.randn(layers, s, hkv, 128, generator=g, device="cuda",
                     dtype=bf16)
    bias = torch.zeros(1, s, device="cuda")
    n = torch.tensor(kv_len, dtype=torch.int32, device="cuda")
    mask = bias[:, :kv_len].to(bf16)[None, None]
    err = max(check_k1(f"T=1 Hq={hq} Hkv={hkv} S={s} kv_len={kv_len} "
                       f"layer {i} bfloat16", q, ks[i], vs[i], bias, n,
                       kv_len) for i in (0, layers - 1))

    def kernel(i):
        K1.decode_attention(q, ks[i % layers], vs[i % layers], bias, n)

    def plain(i):
        K1.decode_attention_reference(q, ks[i % layers], vs[i % layers],
                                      bias, kv_len)

    def library(i):
        kk = ks[i % layers, :kv_len].permute(1, 0, 2)[None]
        vv = vs[i % layers, :kv_len].permute(1, 0, 2)[None]
        F.scaled_dot_product_attention(q.permute(1, 0, 2)[None], kk, vv,
                                       attn_mask=mask, enable_gqa=hq != hkv)

    timed = {name: graph_ms(fn, layers) for name, fn in (
        ("plain", plain), ("kernel", kernel), ("library", library),
        ("kernel2", kernel), ("plain2", plain))}
    ms = min(timed["kernel"], timed["kernel2"])
    nbytes = 2 * hq * 128 * 2 + 2 * kv_len * hkv * 128 * 2 + kv_len * 4
    ops = 4 * hq * kv_len * 128
    by_bytes = nbytes / HBM_BYTES_PER_S >= ops / BF16_OPS_PER_S
    bound_s = max(nbytes / HBM_BYTES_PER_S, ops / BF16_OPS_PER_S)
    log(f"[K1] {label}: T=1 Hq={hq} Hkv={hkv} S={s} kv_len={kv_len} bf16 "
        f"over {layers} caches ("
        f"{2 * layers * kv_len * hkv * 128 * 2 / 1e6:.0f} MB live, cold in "
        f"L2) on {card}: "
        f"kernel {timed['kernel'] * 1e3:.2f}/{timed['kernel2'] * 1e3:.2f} "
        f"us, plain {timed['plain'] * 1e3:.2f}/{timed['plain2'] * 1e3:.2f} "
        f"us, sdpa{' (enable_gqa)' if hq != hkv else ''} "
        f"{timed['library'] * 1e3:.2f} us, bound "
        f"{bound_s * 1e6:.2f} us ({nbytes / 1e6:.3f} MB by "
        f"{'bytes' if by_bytes else 'operations'}), share of bound "
        f"{bound_s * 1e3 / ms:.3f}")
    return {"shape": f"T=1 Hq={hq} Hkv={hkv} S={s} kv_len={kv_len} bf16",
            "launches": None, "max_abs_err": err, "ms": ms,
            "plain_ms": min(timed["plain"], timed["plain2"]),
            "bound_ms": bound_s * 1e3,
            "bound_by": "bytes" if by_bytes else "operations",
            "library_ms": timed["library"]}


def run_13b(max_new: int = NEW_13B, bits: int = 8, device="cuda",
            prompt_tokens: int = PROMPT_TOKENS, n_img: int = N_IMG,
            widths=WIDTHS, max_seq: int = MAX_SEQ, cfg=None) -> dict:
    """LLaVA-13B with an int8 target (``bench.py --model 13b --quant
    int8``): 40 layers, hidden 5120, 40 heads; the target and two medusa
    drafts initialised on the card from seeded generators, the target
    quantized layer by layer (its bf16 layers are never whole); one
    64-token image prompt x ``max_new`` tokens through ``_quant_runs``
    (MSD, null-draft MSD, AR, eager MSD, the oracle draft; K1 40 per AR
    token decoded). K1 is held to its plain twin at 40 heads and timed
    there beside the twin, SDPA and its bound (``time_k1_row``)."""
    import torch
    from msd_tpu_torch.configs import (IMAGE_TOKEN_INDEX, DraftConfig,
                                       EngineConfig, LlamaConfig, TreeConfig)
    from msd_tpu_torch.models import draft as D
    from msd_tpu_torch.models import llama as L
    from msd_tpu_torch.ops.quant import quantize_tensor
    from msd_tpu_torch.ops.sampling import SamplingParams

    on_card = str(device).startswith("cuda")
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    dtype = torch.bfloat16 if on_card else torch.float32
    cfg = cfg or dataclasses.replace(LlamaConfig.llava_13b(),
                                     residual_dtype="float32")
    t_phase = time.perf_counter()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated() if on_card else 0
    g = torch.Generator(device=device).manual_seed(13)
    h, n = cfg.hidden_size, cfg.num_hidden_layers
    layers = L.quantize_layers(
        lambda i: L._layer(L.init_layers(cfg, 1, g, device, dtype), 0), n,
        bits)
    embed = torch.randn(cfg.vocab_size, h, generator=g, dtype=dtype,
                        device=device).mul_(h ** -0.5)
    head = torch.randn(h, cfg.vocab_size, generator=g, dtype=dtype,
                       device=device).mul_(h ** -0.5 * HEAD_SHARPEN)
    tp = {"embed_tokens": embed, "layers": layers,
          "norm": torch.ones(h, dtype=dtype, device=device)}
    tp["lm_head"], tp["lm_head" + L.quant_suffix(bits)] = \
        quantize_tensor(head, -2, bits)
    del head
    dcfg = DraftConfig(text=cfg, medusa_heads=len(widths) - 1)
    drafts = {}
    for name in ("msd", "null"):
        dp = D.init_draft_params(dcfg, g, device, dtype)
        dp["medusa"] = D.init_medusa_params(dcfg, g, device, dtype)
        dp["embed_tokens"] = embed
        drafts[name] = dp
    sync()
    init_s = time.perf_counter() - t_phase
    log(f"[13b] LLaVA-13B target int8 ({n} layers, hidden {h}, "
        f"{cfg.num_attention_heads} heads) initialised and quantized layer "
        f"by layer on {device} in {init_s:.1f}s: target "
        f"{_weight_bytes(tp) / 1e9:.2f} GB, two bf16 medusa drafts "
        f"{2 * (_weight_bytes(drafts['msd']) - embed.numel() * embed.element_size()) / 1e9:.2f} GB; "
        f"allocated {(torch.cuda.memory_allocated() - base) / 2**30 if on_card else 0:.2f} GiB "
        f"over the {base / 2**30:.2f} GiB held before")
    rng = np.random.default_rng(13)
    ids = rng.integers(3, min(31000, cfg.vocab_size - 1),
                       size=prompt_tokens).astype(np.int32)
    ids[1] = IMAGE_TOKEN_INDEX
    feats = torch.from_numpy(rng.normal(size=(n_img, h)) * 0.02).to(
        device=device, dtype=dtype)
    tree = TreeConfig(top_k=widths[0], max_depth=len(widths),
                      num_nodes=1 + sum(widths), medusa_widths=tuple(widths))
    eng = EngineConfig(max_seq_len=max_seq, prompt_pad_multiple=128,
                       tree=tree)
    out = _quant_runs("13B int8 target", tp, drafts, cfg, dcfg, eng,
                      SamplingParams(greedy_round_bits=ROUND_BITS), ids,
                      feats, max_new, 4, widths, device, on_card, sync,
                      prompt_tokens + n_img - 1)
    out["init_s"] = init_s
    if on_card:
        # 40 layer caches at kv_len 672 hold 550 MB of live K/V: cold in L2
        out["k1_row"] = time_k1_row(smi_name_and_limit(), "LLaVA-13B AR row",
                                    cfg.num_attention_heads,
                                    cfg.num_key_value_heads, 672, 1280, n)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[13b] phase took {out['seconds']:.1f}s")
    return out


def _qwen_inputs(gen, ids, feats, grid):
    """The fused embeddings [rows, H] of the inline sequence ``ids`` (its
    image- or video-pad span replaced by ``feats`` when given) and the
    mrope cos/sin rows of all its rows (``mrope_positions`` over the whole
    length for ``grid`` (gh, gw) or (grid_t, gh, gw), gathered by
    ``mrope_gather``; 1-D positions without a visual), built by
    concatenation, apart from the engine's fusion."""
    import torch
    from msd_tpu_torch.models.qwen2vl import (IMAGE_PAD_ID, VIDEO_PAD_ID,
                                              mrope_gather, mrope_positions)

    ids = np.asarray(ids, np.int64)
    table, dev = gen.params["target"]["embed_tokens"], gen.device

    def embed(x):
        return table[torch.from_numpy(
            np.clip(x, 0, table.shape[0] - 1)).to(dev)]

    rows = len(ids)
    if feats is None:
        emb, start, n, (gt, gh, gw) = embed(ids), rows, 0, (1, 1, 1)
    else:
        start = int(np.argmax(np.isin(ids, (IMAGE_PAD_ID, VIDEO_PAD_ID))))
        n, (gt, gh, gw) = len(feats), (1,) * (3 - len(grid)) + tuple(grid)
        emb = torch.cat([embed(ids[:start]), feats.to(table.dtype),
                         embed(ids[start + n:])])
    pos3, _ = mrope_positions(rows, start, n, gh, gw, grid_t=gt)
    cos, sin = mrope_gather(gen.params["cos_t"], gen.params["sin_t"],
                            torch.from_numpy(pos3).to(dev),
                            gen.mrope_section)
    return emb, cos, sin


def qwen_plain_hidden(gen, ids, feats, grid, cfg=None):
    """The target's final-normed hidden rows over the unpadded inline
    sequence ``ids`` (a Qwen2-VL prompt, its image-pad span replaced by
    ``feats`` when given), built apart from ``qwen_prefill``, the decode
    steps, ``qwen_score_program`` and the training records:
    ``_qwen_inputs``, the causal mask by ``triu``, no bucket padding, no
    KV cache reuse; under ``cfg`` (default the generator's). Only
    ``llama_forward`` is shared with the engine."""
    import torch
    from msd_tpu_torch.models import llama as L

    tp, dev = gen.params["target"], gen.device
    cfg = cfg or gen.tcfg
    emb, cos, sin = _qwen_inputs(gen, ids, feats, grid)
    rows = emb.shape[0]
    mask = torch.full((rows, rows), -1e30, device=dev).triu(1)
    hidden, _ = L.llama_forward(
        tp, cfg, emb, torch.arange(rows, dtype=torch.int32, device=dev),
        L.init_kv_cache(cfg, rows, emb.dtype, dev), 0, mask, cos, sin)
    return hidden


def qwen_plain_logits(gen, ids, feats, grid):
    """The target's fp32 logits over the unpadded inline sequence ``ids``
    (``qwen_plain_hidden``, then ``lm_head``)."""
    from msd_tpu_torch.models import llama as L

    return L.lm_head(gen.params["target"],
                     qwen_plain_hidden(gen, ids, feats, grid))


def qwen_record_check(gen, qcfg, ids, feats, grid, tol: float) -> dict:
    """One Qwen2-VL training record (``make_qwen_record_from_ids``, the
    ids padded to the next multiple of 128, loss on every row after the
    image span) over the generator's target: the layout of the JAX
    package's record (keys, shapes, dtypes, the image rows of
    ``img_mask``, ``attn_len``, a non-zero ``loss_mask``); its hidden rows
    bitwise those of ``qwen_plain_hidden`` over the same padded ids (the
    record's row shape, built apart from the record's code) and, against
    the unpadded recompute, within ``tol`` row-relative L2 (the two
    differ by the rounding of other product shapes), both under the
    record's own config (``qcfg.as_llama()``). Raises otherwise; returns
    the unpadded recompute's worst row error and the seconds."""
    import torch
    from msd_tpu_torch.models.qwen2vl import IMAGE_PAD_ID
    from msd_tpu_torch.train.data_gen import make_qwen_record_from_ids

    t0 = time.perf_counter()
    ids = np.asarray(ids, np.int32)
    n = len(ids)
    span = np.nonzero(ids == IMAGE_PAD_ID)[0]
    pad = (n + 127) // 128 * 128
    mask = np.zeros(n, np.float32)
    mask[span[-1] + 1:] = 1.0
    rec = make_qwen_record_from_ids(gen.params["target"], qcfg, ids, mask,
                                    pad, img_feats=feats, grid_hw=grid)
    bad = record_fields_check(rec, pad, qcfg.hidden_size)
    j = np.arange(pad)
    want_img = (j + 1 >= span[0]) & (j + 1 < span[0] + len(span))
    if not np.array_equal(rec["img_mask"], want_img):
        bad.append("img_mask rows")
    if int(rec["attn_len"]) != n or rec["loss_mask"].sum() == 0:
        bad.append(f"attn_len {int(rec['attn_len'])} (want {n}), loss_mask "
                   f"sum {rec['loss_mask'].sum()}")
    cfg = qcfg.as_llama()
    padded = np.zeros(pad, np.int32)
    padded[:n] = ids
    shaped = qwen_plain_hidden(gen, padded, feats, grid, cfg).float()
    got = torch.from_numpy(rec["hidden"]).to(shaped.device)
    if not torch.equal(got, shaped):
        bad.append(f"hidden rows off the recompute at the record's "
                   f"{pad}-row shape: max |diff| "
                   f"{(got - shaped).abs().max().item():.3e}")
    ref = qwen_plain_hidden(gen, ids, feats, grid, cfg).float()
    err = ((got[:n] - ref).norm(dim=-1) / ref.norm(dim=-1)).max().item()
    if not err <= tol:
        bad.append(f"hidden rows off the unpadded recompute: worst "
                   f"relative row error {err:.3e} > {tol:g}")
    if bad:
        raise AssertionError(f"[qwen] training record: {bad}")
    return {"err": err, "rows": n, "pad": pad,
            "seconds": time.perf_counter() - t0}


def _shaped_rows(gen, n_p: int, n_t: int, chunk: int) -> tuple:
    """(the prompt's bucket rows, the token rows fed in ``chunk``-row
    chunks, the rows of both) of ``shaped_logits``."""
    m = gen.eng.prompt_pad_multiple
    pad, fed = -m * (-n_p // m), -chunk * (-n_t // chunk)
    return pad, fed, max(pad, n_p + fed)


def shaped_logits(gen, emb, cos, sin, n_p: int, n_t: int, chunk: int,
                  window: bool = False, ar: bool = False):
    """The logits that predict each of ``n_t`` tokens after an ``n_p``-row
    prompt, and the token after them ([n_t + 1, V] fp32), recomputed at
    the engine's row shapes but apart from its code. ``emb`` [rows, H]
    (``_shaped_rows``): the prompt's rows, the tokens' embeddings, then
    token 0's; ``cos``/``sin`` index by position. The prompt padded to the
    generator's prompt bucket in one forward into a cache of the engine's
    target capacity (the last prompt row through ``lm_head`` alone, as the
    prefill's bonus row), then the tokens ``chunk`` rows at a time (the
    last chunk padded), each chunk written after the rows before it and
    attending over the cache by a causal bias, its rows through
    ``lm_head`` together. ``chunk`` 48 is a verify's row count, 1 the AR
    row's. With ``window`` a chunk row reduces its last ``max_path_len``
    positions through window slots and the cache below them through the
    bias, as a verify row of a chain does (``windowed_attention``; window
    rows and bias built here from the row's cache position); with ``ar``
    (``chunk`` 1) a row attends through K1 over the keys up to its own, as
    the AR step does; else the attention is plain (no K1)."""
    import torch
    from msd_tpu_torch.models import llama as L
    from msd_tpu_torch.ops.attention import NEG_INF

    tp, dev, cfg = gen.params["target"], gen.device, gen.tcfg
    pad, fed, _ = _shaped_rows(gen, n_p, n_t, chunk)
    s = -128 * (-(gen.eng.max_seq_len + gen.eng.tree.num_nodes) // 128)
    pre = emb[:pad].clone()
    pre[n_p:] = gen.params["target"]["embed_tokens"][0]
    kv = L.init_kv_cache(cfg, s, emb.dtype, dev)
    cols = torch.arange(s, device=dev)

    w = gen.eng.tree.max_path_len

    def forward(x, first, win=False, k1=False):
        r = torch.arange(first, first + x.shape[0], device=dev)
        if not win:
            bias = torch.where(cols[None] <= r[:, None], 0.0, NEG_INF)
            kv_len = torch.tensor(first + 1, dtype=torch.int32,
                                  device=dev) if k1 else None
            return L.llama_forward(tp, cfg, x, r.to(torch.int32), kv, first,
                                   bias, cos, sin, kv_len=kv_len)[0]
        start = r - (w - 1)
        slots = start[:, None] + torch.arange(w, device=dev)
        bias = torch.where(cols[None] < start[:, None], 0.0, NEG_INF)
        win_bias = torch.where(slots >= 0, 0.0, NEG_INF)
        return L.llama_forward(
            tp, cfg, x, r.to(torch.int32), kv, first, bias, cos, sin,
            win=(slots.clamp(0, s - 1), win_bias, start))[0]

    out = [L.lm_head(tp, forward(pre, 0)[n_p - 1:n_p])]
    for c in range(0, fed, chunk):
        out.append(L.lm_head(tp, forward(emb[n_p + c:n_p + c + chunk],
                                         n_p + c, window, ar)))
    return torch.cat(out)[:n_t + 1]


def qwen_shaped_logits(gen, ids, feats, grid, toks, chunk: int,
                       window: bool = False):
    """``shaped_logits`` of the tokens ``toks`` after the inline prompt
    ``ids``, inputs and mrope tables from ``_qwen_inputs``."""
    ids = np.asarray(ids, np.int64)
    toks = np.asarray(toks, np.int64)
    n_p, n_t = len(ids), len(toks)
    seq = np.zeros(_shaped_rows(gen, n_p, n_t, chunk)[2], np.int64)
    seq[:n_p], seq[n_p:n_p + n_t] = ids, toks
    emb, cos, sin = _qwen_inputs(gen, seq, feats, grid)
    return shaped_logits(gen, emb, cos, sin, n_p, n_t, chunk, window)


def qwen_logits_fn(gen, ids, feats, grid):
    """``logits(toks, chunk=None)`` of ``token_check`` for an inline
    (Qwen2-VL) prompt: the rows predicting each of ``toks`` and the token
    after them, unpadded (``qwen_plain_logits``) or at the engine's row
    shapes in ``chunk``-row chunks (``qwen_shaped_logits``, through window
    slots when ``chunk`` > 1)."""
    def logits(toks, chunk=None):
        if chunk is None:
            return qwen_plain_logits(gen, np.concatenate([ids, toks]), feats,
                                     grid)[len(ids) - 1:]
        return qwen_shaped_logits(gen, ids, feats, grid, toks, chunk,
                                  window=chunk > 1)
    return logits


def llava_logits_fn(gen, ids, feats):
    """``logits(toks, chunk=None)`` of ``token_check`` for an expand-mode
    (LLaVA) prompt whose image rows (one block, or a list of blocks) are
    spliced in by concatenation (``_llava_inputs``): unpadded
    (``plain_rows_logits``) or at the engine's row shapes
    (``shaped_logits``, the fused prompt padded to the bucket), over the
    rope tables."""
    return rows_logits_fn(gen, _llava_inputs(gen, ids, feats)[0])


def rows_logits_fn(gen, prompt):
    """``logits(toks, chunk=None, ar=False)`` of ``token_check`` for a
    prompt given as its embedded rows ``prompt`` [n_p, H] at 1-D positions
    0..n_p-1: the tokens' embeddings appended, unpadded
    (``plain_rows_logits``) or at the engine's row shapes
    (``shaped_logits``; ``ar``: one-row chunks through K1), over the rope
    tables."""
    import torch

    table = gen.params["target"]["embed_tokens"]
    cos, sin = gen.params["cos_t"], gen.params["sin_t"]
    n_p = prompt.shape[0]

    def logits(toks, chunk=None, ar=False):
        toks = np.asarray(toks, np.int64)
        n_t = len(toks)
        rows = n_p + n_t if chunk is None else \
            _shaped_rows(gen, n_p, n_t, chunk)[2]
        seq = np.zeros(rows - n_p, np.int64)
        seq[:n_t] = toks
        emb = torch.cat([prompt, table[torch.from_numpy(seq).to(gen.device)]])
        if chunk is None:
            return plain_rows_logits(gen, emb, cos, sin)[n_p - 1:]
        return shaped_logits(gen, emb, cos, sin, n_p, n_t, chunk,
                             window=chunk > 1, ar=ar)
    return logits


def qwen_token_check(gen, ids, feats, grid, toks, other=None,
                     tie: float = 0.0) -> dict:
    """``token_check`` of an inline (Qwen2-VL) request's committed tokens
    ``toks`` after the prompt ``ids`` (``qwen_logits_fn``)."""
    return token_check(gen, qwen_logits_fn(gen, ids, feats, grid), toks,
                       other, tie)


def token_check(gen, logits, toks, other=None, tie: float = 0.0) -> dict:
    """Every committed token ``toks`` of one request held to two
    recomputes over the prompt and those tokens, each built apart from the
    engine's code (``logits``: ``qwen_logits_fn``, ``llava_logits_fn``). B
    (``logits(toks, num_nodes)``, at the verify's shapes: the prompt
    bucket, chunks of the tree's node count through window slots) must
    have each token as its argmax after the engine's canonical rounding,
    exactly. A, the unpadded ``logits(toks)``, must have each token as its
    canonical argmax or, on the card (``tie`` > 0), lie below A's top by
    at most ``tie`` bf16 ulps plus that row's noise: |A - B| at A's top
    token plus |A - B| at the committed token, in bf16 ulps of A's top
    (0 where A and B agree bitwise). Off the card both must be exact.
    With ``other`` (the AR run's tokens of the same request): where they
    first depart from ``toks``, the two tokens' logits in A, their gap in
    bf16 ulps of the larger, that row's noise over the two tokens, the
    largest of B's and of C's (``logits(toks, 1)``, the AR row's shape),
    and their ranks (a sequence that ended first picks EOS there).
    Returns {"worst", "noise", "off": tokens off A's
    canonical argmax, "off_b": off B's, "bad_a": tokens A's gate
    rejects, "bad": [(k, ulps below A's top,
    allowed, ulps below B's top, rank in A)], "rows": [(k, ulps below A's top, noise, ulps below B's top,
    rank in A)] for every token off A's canonical argmax, "split": {...}
    or None}."""
    import torch
    from msd_tpu_torch.ops.sampling import canon_logits

    toks = [int(t) for t in toks]
    out = {"worst": 0.0, "noise": 0.0, "off": 0, "off_b": 0, "bad_a": 0,
           "bad": [], "rows": [], "split": None}
    if not toks:
        return out
    a_rows = logits(toks)
    rows = a_rows[:len(toks)]
    shaped = logits(toks, gen.eng.tree.num_nodes)
    b_rows = shaped[:len(toks)]
    top, arg = rows.max(dim=-1)
    ulp = bf16_ulp(top)
    idx = torch.tensor(toks, device=rows.device)[:, None]

    def canon_max(r):
        c = canon_logits(r, ROUND_BITS)
        return c.gather(1, idx)[:, 0] >= c.max(dim=-1).values

    gap = (rows - b_rows).abs()
    noise = (gap.gather(1, arg[:, None])[:, 0] + gap.gather(1, idx)[:, 0]) \
        / ulp
    ulps = (top - rows.gather(1, idx)[:, 0]) / ulp
    d_b = (b_rows.max(dim=-1).values - b_rows.gather(1, idx)[:, 0]) / ulp
    rank = (rows > rows.gather(1, idx)).sum(dim=-1)
    is_max, b_max = canon_max(rows), canon_max(b_rows)
    allowed = tie + noise if tie > 0 else torch.zeros_like(noise)
    ok = b_max & (is_max | (ulps <= allowed))
    out.update(worst=float(torch.where(is_max, 0.0, ulps).max()),
               noise=float(noise.max()), off=int((~is_max).sum()),
               off_b=int((~b_max).sum()),
               bad_a=int((~(is_max | (ulps <= allowed))).sum()),
               bad=[(int(k), float(ulps[k]), float(allowed[k]),
                     float(d_b[k]), int(rank[k]))
                    for k in np.flatnonzero(~ok.cpu().numpy())],
               rows=[(int(k), float(ulps[k]), float(noise[k]),
                      float(d_b[k]), int(rank[k]))
                     for k in np.flatnonzero(~is_max.cpu().numpy())])
    if other is not None:
        out["split"] = split_record(gen, logits, toks, other, a_rows, shaped)
    return out


def split_record(gen, logits, toks, other, a_rows=None, shaped=None):
    """Where one request's committed tokens ``toks`` (MSD) and ``other``
    (AR) first part (a sequence that ended first picks EOS there), or None
    where they do not: the two tokens' logits in A (``logits(toks)``,
    unpadded; ``a_rows`` where the caller has it), their gap in bf16 ulps
    of the larger, their ranks, and that row's noise over the two tokens:
    the larger of |A - R| summed over them, in those ulps, for R the
    verify-shaped recompute (``logits(toks, num_nodes)``; ``shaped``
    where the caller has it) and the one-row one (``logits(toks, 1)``, the
    AR row's shape, plain attention). No recompute goes through K1."""
    toks, other = [int(t) for t in toks], [int(t) for t in other]
    k = next((i for i, (x, y) in enumerate(zip(toks, other)) if x != y),
             min(len(toks), len(other)))
    if k == max(len(toks), len(other)):
        return None
    row = (logits(toks[:k]) if a_rows is None else a_rows)[k]
    if shaped is None:
        shaped = logits(toks[:k], gen.eng.tree.num_nodes)
    ta, tb = (s[k] if k < len(s) else gen.eos_id for s in (toks, other))
    la, lb = float(row[ta]), float(row[tb])
    ulp = float(bf16_ulp(max(abs(la), abs(lb))))
    return {"at": k, "gap": abs(la - lb), "logit": max(abs(la), abs(lb)),
            "ulps": abs(la - lb) / ulp,
            "noise": max(_pair_gap(row, r[k], ta, tb)
                         for r in (shaped, logits(toks[:k], 1))) / ulp,
            "ranks": (int((row > row[ta]).sum()), int((row > row[tb]).sum()))}


def _pair_gap(x, y, ta: int, tb: int) -> float:
    """|x - y| at token ta plus at token tb, for two logit rows."""
    return float((x[ta] - y[ta]).abs() + (x[tb] - y[tb]).abs())


def k1_split_check(gen, logits, toks, other, split: dict) -> dict:
    """The AR row of ``split`` (``split_record`` of MSD's tokens ``toks``
    and AR's ``other``), where MSD committed ta and AR tb, recomputed at
    the AR row's shape (``logits(toks[:at], 1, ar=True)`` of
    ``rows_logits_fn``: one-row chunks through ``llama.decode_attention``)
    twice: through K1, each of its calls held against its plain twin on
    the same inputs (``TOL``: the twin check at every kv_len of the row's
    decode), and through the twin. Returns {"calls": K1's calls, "excess":
    the largest |K1 - twin| - rtol |twin| over them, "within": K1 ran at
    each layer of each row and excess <= atol, "picks_b": tb is the K1
    row's canonical argmax, "dev": |K1 row - twin row| over ta and tb, in
    bf16 ulps of the split's logit}. K1's launch count grows by
    "calls"."""
    from msd_tpu_torch.models import llama as L
    from msd_tpu_torch.ops import decode_attention as K1
    from msd_tpu_torch.ops.sampling import canon_logits

    at = split["at"]
    prefix = [int(t) for t in toks[:at]]
    ta, tb = (int(s[at]) if at < len(s) else gen.eos_id
              for s in (toks, other))
    ulp = float(bf16_ulp(split["logit"]))
    seen = {"calls": 0, "excess": 0.0, "atol": 0.0}

    def twin(q, k, v, bias, n):
        return K1.decode_attention_reference(q, k, v, bias, int(n))

    def checked(q, k, v, bias, n):
        got, ref = K1.decode_attention(q, k, v, bias, n), twin(q, k, v,
                                                               bias, n)
        atol, rtol = TOL[str(ref.dtype)[6:]]
        seen["calls"] += 1
        seen["atol"] = atol
        seen["excess"] = max(seen["excess"], float(
            ((got.float() - ref.float()).abs()
             - rtol * ref.float().abs()).max()))
        return got

    orig, rows = L.decode_attention, {}
    try:
        for name, fn in (("k1", checked), ("twin", twin)):
            L.decode_attention = fn
            rows[name] = logits(prefix, 1, ar=True)[len(prefix)]
    finally:
        L.decode_attention = orig
    c = canon_logits(rows["k1"][None].float(), ROUND_BITS)[0]
    return {"calls": seen["calls"], "excess": seen["excess"],
            "within": 0 < seen["calls"]
            == gen.tcfg.num_hidden_layers * len(prefix)
            and seen["excess"] <= seen["atol"],
            "picks_b": bool(c[tb] >= c.max()),
            "dev": _pair_gap(rows["k1"], rows["twin"], ta, tb) / ulp}


def split_ok(split, tie: float) -> bool:
    """An AR-vs-MSD split (``split_record``) is a rounding tie of the
    recompute: the two tokens' logits within ``tie`` bf16 ulps plus that
    row's recompute noise over the two tokens; or, beyond that, K1's
    arithmetic at the AR row within its contract (``k1_split_check``):
    the K1 recompute picks AR's token, each of its K1 calls lies within
    ``TOL`` of the twin on the same inputs (the cap K1's tolerance sets;
    a tolerance-sized move of the twin's outputs does not bound the row's
    change, which at random weights is not monotone in the move's size),
    and the gap lies within ``tie`` plus the noise plus the K1 row's
    departure from the twin's. No split at all off the card (``tie``
    0)."""
    if split is None:
        return True
    if tie <= 0:
        return False
    k1 = split.get("k1")
    return split["ulps"] <= tie + split["noise"] or (
        k1 is not None and k1["picks_b"] and k1["within"]
        and split["ulps"] <= tie + split["noise"] + k1["dev"])


def qwen_plain_score(gen, ids, cont_start: int, feats, grid) -> tuple:
    """The plain recompute of an inline ``MSDGenerator.score``:
    ``qwen_plain_logits``, ``log_softmax`` and a gather of the
    continuation rows' next tokens. Returns (logprob_sum, is_greedy)."""
    import torch

    logits = qwen_plain_logits(gen, ids, feats, grid)
    logp = torch.log_softmax(logits, dim=-1)
    r = torch.arange(cont_start - 1, len(ids) - 1, device=gen.device)
    nxt = torch.from_numpy(np.asarray(ids, np.int64)).to(gen.device)[r + 1]
    return (float(logp[r, nxt].sum()),
            bool((logp[r].argmax(dim=-1) == nxt).all()))


def qwen_prompt(rng, n_tokens: int, n_img: int, vocab_hi: int,
                with_image: bool, span=None) -> np.ndarray:
    """A random ``n_tokens`` text prompt; with an image, the span
    ``span`` = (start, pad, end) ids, start, pad x n_img, end, after its
    first token (by default Qwen2-VL's <|vision_start|> <|image_pad|>
    <|vision_end|>)."""
    from msd_tpu_torch.models.qwen2vl import (IMAGE_PAD_ID, VISION_END_ID,
                                              VISION_START_ID)
    start, pad, end = span or (VISION_START_ID, IMAGE_PAD_ID, VISION_END_ID)
    ids = rng.integers(3, vocab_hi, size=n_tokens)
    if with_image:
        ids = np.concatenate([ids[:1], [start], np.full(n_img, pad), [end],
                              ids[1:]])
    return ids.astype(np.int32)


def qwen_fault_check(make_gen, prompts, good, max_new: int, tie: float,
                     card: str) -> dict:
    """The recompute gate's power at full width: MSD runs again on the
    image ``prompts`` on a fresh generator (``make_gen``) whose verify
    drops ``pos_delta`` from its rope positions (cache rows unchanged),
    the fault a lost image offset makes; ``qwen_token_check`` at the
    phase's allowance must reject some of its tokens, by A's gate and by
    B's, or this raises. ``good``: the true runs' results. Returns {"bad":
    tokens rejected, "by_a", "by_b": rejected by each gate, "worst": (ulps, allowed) of the farthest, "differ": first
    token index that differs from the true run per prompt}."""
    from msd_tpu_torch.engine import spec_engine as SE

    orig = SE.verify_forward

    def no_delta(tp, tcfg, kv, E, tr, cos_t, sin_t, per_lane=frozenset(),
                 pos_delta=None):
        return orig(tp, tcfg, kv, E, tr, cos_t, sin_t, per_lane)

    SE.verify_forward = no_delta
    try:
        gen = make_gen()
        runs = [gen.generate(ids, f, max_new, img_grid=grid)
                for ids, f, grid in prompts]
    finally:
        SE.verify_forward = orig
    bad, differ, by_a, by_b = [], [], 0, 0
    for (ids, f, grid), r, ok in zip(prompts, runs, good):
        chk = qwen_token_check(gen, ids, f, grid, r.tokens, tie=tie)
        bad += chk["bad"]
        by_a, by_b = by_a + chk["bad_a"], by_b + chk["off_b"]
        d = np.flatnonzero(r.tokens != ok.tokens)
        differ.append(int(d[0]) if len(d) else None)
    del gen
    if not (by_a and by_b):
        raise AssertionError(f"[qwen] a verify without pos_delta passes the "
                             f"recompute gate: A's rejects {by_a} tokens, "
                             f"B's {by_b} (tokens first differ from the true "
                             f"run at {differ})")
    worst = max(bad, key=lambda b: b[1] - b[2])
    log(f"[qwen] planted fault (the verify's rope positions without "
        f"pos_delta), {len(prompts)} image prompts x {max_new} tokens: the "
        f"tokens first differ from the true run at {differ}; the recompute "
        f"gate rejects {len(bad)} of them, {by_a} by A's allowance and "
        f"{by_b} off the shaped recompute's argmax (token, ulps below A's top, "
        f"allowed, below B's, rank: "
        + ", ".join(f"({k}, {u:g}, {a:g}, {b:g}, {rk})"
                    for k, u, a, b, rk in bad)
        + f"), so [qwen] fails it, as it must, on {card}")
    return {"bad": len(bad), "by_a": by_a, "by_b": by_b,
            "worst": worst[1:3], "differ": differ}


def video_full_attention(vision, vcfg, x, gt: int, gh: int, gw: int):
    """The planted fault of ``[video]``: the tower over a video's patch
    embeddings ``x`` with every row attending across all ``gt`` temporal
    blocks (the same blocks, rotary rows and merger otherwise)."""
    from msd_tpu_torch.models import qwen2vl_vision as QV

    cos, sin = QV.vision_rotary(vcfg, gh, gw, grid_t=gt, device=x.device)
    blocks = vision["blocks"]
    for i in range(blocks["qkv_w"].shape[0]):
        x = QV._block({k: w[i] for k, w in blocks.items()}, vcfg, x,
                      cos[:, None], sin[:, None], 1)
    return QV.merge(vision, vcfg, x)


def run_video(gen, drafts, vision, vcfg, lc, image_size: int, max_new: int,
              tie: float, card: str, n_frames: int = VIDEO_FRAMES,
              max_new_warm: int = 4) -> dict:
    """Qwen2-VL video on ``[qwen]``'s weights: ``n_frames`` seeded
    ``image_size`` frames through the native prep and the tower's video
    path (attention per temporal block), held to its plain
    block-per-block evaluation (each temporal block through the tower
    alone); a planted fault, full attention across the blocks, must fail
    that gate. Then the ``qwen2_vl_msd`` adapter over ``gen``
    (``from_qwen``: its prompt with the <|video_pad|> span,
    ``_encode_video``, ``video_gen``, which holds ``gen``'s tensors) runs
    graph MSD, null-draft MSD and the AR baseline (K1). Fails unless MSD ==
    the null draft, bitwise; every committed MSD token passes
    ``token_check`` against the mrope recompute at grid_t (``tie``); AR
    equals MSD up to the first split, each split such a tie; K1 launches
    layers x AR tokens decoded, 0 in MSD; no capture in a timed run.
    Prints the tower's ms per video and peak memory, the prefill ms and
    the replayed step."""
    import torch
    from msd_tpu_torch.engine import spec_engine as SE
    from msd_tpu_torch.harness.models.llava_msd import SimpleTokenizer
    from msd_tpu_torch.harness.models.qwen2_vl_msd import Qwen2VLMSD
    from msd_tpu_torch.models import qwen2vl_vision as QV
    from msd_tpu_torch.ops import decode_attention as K1
    from msd_tpu_torch.utils.mm_utils import process_image

    device = gen.device
    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    t_phase = time.perf_counter()
    out = {}
    rng = np.random.default_rng(16)
    frames = rng.integers(0, 256, size=(n_frames, image_size, image_size,
                                        3), dtype=np.uint8)
    px = torch.from_numpy(np.stack([process_image(f, image_size)
                                    for f in frames])).to(device)
    p, tp = vcfg.patch_size, vcfg.temporal_patch_size
    gt, gh, gw = -(-n_frames // tp), image_size // p, image_size // p
    feats = QV.qwen_vision_encode_video(vision, vcfg, px)   # warm-up
    sync()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated() if on_card else 0
    t1 = time.perf_counter()
    for _ in range(2):
        feats = QV.qwen_vision_encode_video(vision, vcfg, px)
    sync()
    out["tower_ms"] = (time.perf_counter() - t1) * 1e3 / 2
    out["tower_peak"] = (torch.cuda.max_memory_allocated() - base) \
        if on_card else 0
    x = QV.window_major_patches_video(px.to(vision["patch_embed"].dtype),
                                      vcfg) @ vision["patch_embed"]
    m = gh * gw
    plain = torch.cat([QV._encode_core(vision, vcfg, x[t * m:(t + 1) * m], 1,
                                       gh, gw) for t in range(gt)])

    def rel(a):
        return float((a.float() - plain.float()).norm()
                     / plain.float().norm())

    tol = VIDEO_TOWER_TOL if on_card else 1e-5
    n_rows = gt * m // vcfg.spatial_merge_size ** 2
    out["tower_rel"] = rel(feats)
    if tuple(feats.shape) != (n_rows, lc.hidden_size) \
            or not bool(torch.isfinite(feats).all()) \
            or not out["tower_rel"] <= tol:
        raise AssertionError(f"[video] tower rows {tuple(feats.shape)} "
                             f"(want {n_rows}), relative error against the "
                             f"block-per-block evaluation "
                             f"{out['tower_rel']:.3e} (allowed {tol:g})")
    out["fault_rel"] = rel(video_full_attention(vision, vcfg, x, gt, gh, gw))
    if not out["fault_rel"] > tol:
        raise AssertionError(f"[video] a tower attending across temporal "
                             f"blocks passes the gate: {out['fault_rel']:.3e}"
                             f" <= {tol:g}")
    del x, plain
    log(f"[video] tower: {n_frames} frames of {image_size}px, {gt} temporal "
        f"blocks x {gh}x{gw} patches ({gt * m} rows) merged to {n_rows}; "
        f"{out['tower_ms']:.2f} ms per video, peak "
        f"{out['tower_peak'] / 2**30:.2f} GiB above the weights; relative "
        f"error against the block-per-block evaluation "
        f"{out['tower_rel']:.3e} (allowed {tol:g}); planted full attention "
        f"across blocks {out['fault_rel']:.3e}, rejected, on {card}")

    # the adapter's video path: prompt, frames, tower, video_gen
    adapter = Qwen2VLMSD.from_qwen(gen, SimpleTokenizer(lc.vocab_size),
                                   vision, vcfg, img_grid=(gh, gw),
                                   max_num_frames=n_frames)
    vgen, ids, vfeats, grid = adapter._prep_request(
        "What happens in this video? Describe it step by step.", [frames])
    if vgen is not adapter.video_gen or not torch.equal(vfeats, feats) \
            or vgen.params["target"] is not gen.params["target"] \
            or tuple(grid) != (gt, gh // 2, gw // 2):
        raise AssertionError(f"[video] the adapter's video request: grid "
                             f"{grid}, rows equal the tower's "
                             f"{torch.equal(vfeats, feats)}, target shared "
                             f"{vgen.params['target'] is gen.params['target']}")

    def captures():
        return 0 if vgen.graphs is None else len(vgen.graphs.steps)

    vgen.naive_generate(ids, vfeats, max_new_warm, img_grid=grid)
    for name in ("null", "msd"):
        vgen.params["draft"] = drafts[name]
        vgen.generate(ids, vfeats, max_new_warm, img_grid=grid)
    sync()
    n_cap = captures()
    secs, restore = timed_calls(SE, ("qwen_prefill", "qwen_ar_prefill"))
    runs, wall, launches = {}, {}, {}
    try:
        for name in ("ar", "msd", "null"):
            vgen.params["draft"] = drafts["null" if name == "null" else "msd"]
            K1.decode_attention.launches = 0
            t1 = time.perf_counter()
            r = vgen.naive_generate(ids, vfeats, max_new, img_grid=grid) \
                if name == "ar" else vgen.generate(ids, vfeats, max_new,
                                                   img_grid=grid)
            sync()
            wall[name] = time.perf_counter() - t1
            launches[name] = K1.decode_attention.launches
            runs[name] = r
            if vgen.graphs is not None and not vgen.graphs.reads(
                    r.graph, vgen.params):
                raise AssertionError(f"[video] {name}: replayed a graph "
                                     f"captured for other weights")
    finally:
        restore()
    vgen.params["draft"] = drafts["msd"]
    layers = lc.num_hidden_layers
    decoded = len(runs["ar"].tokens) - 1
    bad = []
    if captures() != n_cap:
        bad.append("a capture inside the timed runs")
    if launches["ar"] != (layers * decoded if on_card else 0) \
            or launches["msd"] or launches["null"]:
        bad.append(f"K1 launches {launches}, want ar {layers} x {decoded} "
                   f"AR tokens decoded, 0 in MSD")
    toks = {n: r.tokens for n, r in runs.items()}
    for n, t in toks.items():
        if t.shape != (max_new,) or t.min() < 0 or t.max() >= lc.vocab_size:
            bad.append(f"{n}: bad tokens {t.shape}")
    if not np.array_equal(toks["msd"], toks["null"]):
        bad.append("MSD and null-draft tokens differ")
    t1 = time.perf_counter()
    chk = token_check(vgen, qwen_logits_fn(vgen, ids, vfeats, grid),
                      toks["msd"], toks["ar"], tie)
    out["check_s"] = time.perf_counter() - t1
    if chk["bad"]:
        bad.append(f"committed tokens off the mrope recompute's argmax "
                   f"(token, ulps below A's top, allowed, below B's, rank): "
                   f"{chk['bad']}")
    if not split_ok(chk["split"], tie):
        bad.append(f"AR departs from MSD at a split that is no rounding "
                   f"tie: {chk['split']}")
    out.update(launches=launches["ar"], ar_decoded=decoded, check=chk,
               prompt_rows=len(ids), n_vid=vgen.n_img,
               max_seq=vgen.eng.max_seq_len,
               prefill_ms=secs["qwen_prefill"][0] * 1e3,
               ar_prefill_ms=secs["qwen_ar_prefill"][0] * 1e3,
               msd_ms_step=wall["msd"] * 1e3 / max(runs["msd"].accept_steps,
                                                    1),
               ar_ms=wall["ar"] * 1e3 / len(toks["ar"]))
    s = chk["split"]
    log(f"[video] video_gen (n_img {vgen.n_img}, max_seq_len "
        f"{vgen.eng.max_seq_len}, the image generator's target and drafts): "
        f"a {len(ids)}-row prompt x {max_new} tokens, mrope grid {grid}: "
        f"graph MSD == null draft: "
        f"{np.array_equal(toks['msd'], toks['null'])}; committed tokens off "
        f"the mrope recompute's canonical argmax {chk['off']} of {max_new} "
        f"(off the shaped recompute's {chk['off_b']}, allowed 0), worst "
        f"{chk['worst']:.2f} ulps, noise up to {chk['noise']:.2f}; AR == "
        f"MSD up to the first split: "
        + ("no split" if s is None else
           f"split at token {s['at']}, {s['ulps']:.1f} ulps (noise "
           f"{s['noise']:g}), ranks {s['ranks']}")
        + f"; K1 launches {launches} (ar = {layers} x {decoded} AR tokens "
        f"decoded) on {card}")
    if bad:
        raise AssertionError(f"[video] {bad}")
    if on_card:
        out["step_replay_ms"] = _replay_ms(vgen, runs["msd"].graph)
        out["ar_replay_ms"] = _replay_ms(vgen, runs["ar"].graph)
    else:
        out["step_replay_ms"] = out["ar_replay_ms"] = float("nan")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[video] prefill {out['prefill_ms']:.2f} ms (MSD), "
        f"{out['ar_prefill_ms']:.2f} ms (AR); replayed verify step "
        f"{out['step_replay_ms']:.3f} ms, AR token {out['ar_replay_ms']:.3f}"
        f" ms; wall {out['msd_ms_step']:.2f} ms/step MSD, {out['ar_ms']:.2f} "
        f"ms/token AR (prefill included); recompute check "
        f"{out['check_s']:.1f}s; phase {out['seconds']:.1f}s on {card}")
    adapter._vgen = None
    del adapter, vgen
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    return out


def run_qwen(root: str, device="cuda", qcfg=None, vcfg=None, widths=WIDTHS,
             max_seq: int = MAX_SEQ, max_new: int = QWEN_NEW,
             prompt_tokens: int = PROMPT_TOKENS, image_size: int = 336,
             limit: int = QWEN_LIMIT, harness_new: int = HARNESS_NEW,
             tasks=HARNESS_TASKS, max_new_warm: int = 4,
             video_frames: int = VIDEO_FRAMES) -> dict:
    """Qwen2-VL-7B at full width (``qcfg``/``vcfg`` cut it for the CPU):
    the qkv-bias GQA 28/4 decoder (bf16 weights, fp32 residual, q/k/v
    biases drawn at std ``QWEN_BIAS_STD``, ``lm_head`` x6), a 13-head
    medusa draft and a null draft at its width, and the Qwen2-VL tower,
    all from seeded generators on the device; a seeded ``image_size``
    image through the tower (144 merged rows at 336); two image prompts
    (``prompt_tokens`` text tokens around the inline <|vision_start|>
    <|image_pad|> x 144 <|vision_end|> span) and one text prompt, each x
    ``max_new`` tokens, 6 canonical rounding bits, the main path's tree.

    Generator runs: graph MSD, eager MSD, graph null-draft MSD and graph
    ``naive_generate`` (AR); the oracle draft (the null-draft tokens on
    the rank-0 chain) on the image prompts; ``generate_batch`` at B = 2
    over the image prompts. Harness runs on the checkpoint
    ``save_qwen2_vl`` and ``save_draft`` write under ``root``:
    ``harness.__main__.main`` in process with ``--model qwen2_vl_msd``,
    A ``--use_msd``, B the AR adapter, D the null draft, on ``tasks`` and
    the video tasks ``QWEN_VIDEO_TASKS``, whose videos the adapter samples
    to ``QWEN_HARNESS_FRAMES`` frames (``--model_args max_num_frames``)
    and decodes on its ``video_gen``.

    Fails unless: graph MSD == eager MSD == the null draft, bitwise, on
    every prompt, and A == D; every committed MSD (and A) token is the
    canonical argmax of an independent mrope recompute at the verify's
    row shapes and of an unpadded one (``qwen_token_check``) or, on the
    card, within ``QWEN_TIE`` bf16 ulps of the unpadded one's top logit
    plus that row's gap between the two recomputes, and
    that gate rejects the tokens of a verify without ``pos_delta``
    (``qwen_fault_check``); AR (and B) equals MSD (and A) up
    to each request's first split, each split such a tie (none off the
    card); the oracle
    draft is accepted to full depth; each batched lane equals its solo
    run; K1 launches layers x AR tokens decoded in the generator's AR
    runs and in B (a capture's warm-up steps included; in B request by
    request), 0 in every MSD run; each video doc of A, B and D, and
    nothing else, ran on ``video_gen`` (a <|video_pad|> span of
    QWEN_HARNESS_FRAMES / 2 temporal blocks); ai2d_ppl scores bitwise
    equal across A, B and a repeat and within 1e-4 (relative, floor 1) of
    their recompute; the loaded
    checkpoint is bitwise the weights in memory; no graph is captured
    in a timed window or after a combination's first harness request."""
    import io

    import torch
    from msd_tpu_torch.configs import DraftConfig, EngineConfig, TreeConfig
    from msd_tpu_torch.engine import spec_engine as SE
    from msd_tpu_torch.engine.generator import MSDGenerator
    from msd_tpu_torch.engine.graphs import WARMUP_STEPS
    from msd_tpu_torch.harness import __main__ as HM
    from msd_tpu_torch.models import draft as D
    from msd_tpu_torch.models.qwen2vl import (VIDEO_PAD_ID,
                                              Qwen2VLTextConfig,
                                              init_qwen2_params)
    from msd_tpu_torch.models.qwen2vl_vision import (
        Qwen2VisionConfig, init_qwen_vision_params, qwen_vision_encode)
    from msd_tpu_torch.ops import decode_attention as K1
    from msd_tpu_torch.ops.sampling import SamplingParams
    from msd_tpu_torch.utils import weights as W
    from msd_tpu_torch.utils.mm_utils import process_image

    on_card = str(device).startswith("cuda")
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    dtype = torch.bfloat16 if on_card else torch.float32
    card = smi_name_and_limit() if on_card else "cpu"
    t_phase = time.perf_counter()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    qcfg = qcfg or Qwen2VLTextConfig()
    vcfg = vcfg or Qwen2VisionConfig(hidden_size=qcfg.hidden_size)
    lc = dataclasses.replace(qcfg.as_llama(), residual_dtype="float32")
    g = torch.Generator(device=device).manual_seed(15)
    tp = init_qwen2_params(qcfg, g, device, dtype)
    for name in ("q_bias", "k_bias", "v_bias"):
        tp["layers"][name].normal_(0.0, QWEN_BIAS_STD, generator=g)
    tp["lm_head"].mul_(HEAD_SHARPEN)
    dcfg = DraftConfig(text=lc, medusa_heads=len(widths) - 1)
    drafts = {}
    for name in ("msd", "null"):
        dp = D.init_draft_params(dcfg, g, device, dtype)
        dp["medusa"] = D.init_medusa_params(dcfg, g, device, dtype)
        dp["embed_tokens"] = tp["embed_tokens"]
        drafts[name] = dp
    vision = init_qwen_vision_params(vcfg, g, device, dtype)
    sync()
    out = {"card": card, "init_s": time.perf_counter() - t_phase}
    log(f"[qwen] Qwen2-VL-7B width: {lc.num_hidden_layers} layers, hidden "
        f"{lc.hidden_size}, GQA {lc.num_attention_heads}/"
        f"{lc.num_key_value_heads}, vocab {lc.vocab_size}, q/k/v biases; "
        f"tower {vcfg.depth} x {vcfg.embed_dim}; target "
        f"{_weight_bytes(tp) / 1e9:.2f} GB, tower "
        f"{_weight_bytes(vision) / 1e9:.2f} GB, initialised on {device} in "
        f"{out['init_s']:.1f}s on {card}")

    # the image through the tower: its rows feed every image request
    m = vcfg.spatial_merge_size
    grid = image_size // vcfg.patch_size
    merged = (grid // m, grid // m)
    n_img = merged[0] * merged[1]
    rng = np.random.default_rng(15)
    image = rng.integers(0, 256, size=(image_size, image_size, 3),
                         dtype=np.uint8)
    px = torch.from_numpy(process_image(image, image_size)).to(device)
    feats = qwen_vision_encode(vision, vcfg, px)
    sync()
    t1 = time.perf_counter()
    for _ in range(3):
        feats = qwen_vision_encode(vision, vcfg, px)
    sync()
    out["tower_ms"] = (time.perf_counter() - t1) * 1e3 / 3
    v32 = _map_tensors(vision, lambda t: t.float())
    ref = qwen_vision_encode(v32, vcfg, px)
    del v32
    out["tower_rel"] = float((feats.float() - ref).norm() / ref.norm())
    if tuple(feats.shape) != (n_img, lc.hidden_size) \
            or not torch.isfinite(feats).all():
        raise AssertionError(f"[qwen] tower output {tuple(feats.shape)}, "
                             f"finite {bool(torch.isfinite(feats).all())}")
    log(f"[qwen] tower: {image_size}x{image_size} image, {grid}x{grid} "
        f"patches merged to {n_img} rows, {out['tower_ms']:.2f} ms per image "
        f"({dtype}), relative error against its fp32 evaluation "
        f"{out['tower_rel']:.3e} on {card}")

    vocab_hi = min(151000, lc.vocab_size - 1)
    prompts = [(qwen_prompt(rng, prompt_tokens, n_img, vocab_hi, True),
                feats, merged),
               (qwen_prompt(rng, prompt_tokens, n_img, vocab_hi, True),
                feats, merged),
               (qwen_prompt(rng, prompt_tokens, n_img, vocab_hi, False),
                None, None)]
    tree = TreeConfig(top_k=widths[0], max_depth=len(widths),
                      num_nodes=1 + sum(widths), medusa_widths=tuple(widths))
    eng = EngineConfig(max_seq_len=max_seq, prompt_pad_multiple=128,
                       tree=tree)

    def generator(cuda_graphs):
        return MSDGenerator(tp, drafts["msd"], lc, dcfg, eng, n_img=n_img,
                            eos_id=-1,
                            sp=SamplingParams(greedy_round_bits=ROUND_BITS),
                            image_mode="inline",
                            mrope_section=qcfg.mrope_section, device=device,
                            cuda_graphs=cuda_graphs)

    gens = {"graph": generator(True), "eager": generator(False),
            "oracle": generator(True)}

    def captures(gen):
        return 0 if gen.graphs is None else len(gen.graphs.steps)

    # warm-up outside the timed window: one capture per step and draft
    ids0, f0, g0 = prompts[0]
    gen = gens["graph"]
    gen.naive_generate(ids0, f0, max_new_warm, img_grid=g0)
    for name in ("null", "msd"):
        gen.params["draft"] = drafts[name]
        gen.generate(ids0, f0, max_new_warm, img_grid=g0)
    gens["eager"].generate(ids0, f0, max_new_warm, img_grid=g0)
    sync()
    n_cap = captures(gen)
    runs, secs, launches = {}, {}, {}
    for pi, (ids, f, grid_i) in enumerate(prompts):
        for name in ("ar", "msd", "null", "eager"):
            gen = gens["eager" if name == "eager" else "graph"]
            gen.params["draft"] = drafts["null" if name == "null" else "msd"]
            # the counts of this path: zeroed just before, read just after
            K1.decode_attention.launches = 0
            t1 = time.perf_counter()
            r = gen.naive_generate(ids, f, max_new, img_grid=grid_i) \
                if name == "ar" else gen.generate(ids, f, max_new,
                                                  img_grid=grid_i)
            sync()
            secs.setdefault(name, []).append(time.perf_counter() - t1)
            launches[name] = launches.get(name, 0) + \
                K1.decode_attention.launches
            runs.setdefault(name, []).append(r)
            if gen.graphs is not None and not gen.graphs.reads(r.graph,
                                                               gen.params):
                raise AssertionError(f"[qwen] {name}: replayed a graph "
                                     f"captured for other weights")
    gen = gens["graph"]
    gen.params["draft"] = drafts["msd"]
    if captures(gen) != n_cap or captures(gens["eager"]):
        raise AssertionError("[qwen] a capture inside the timed runs")
    layers = lc.num_hidden_layers
    ar_decoded = sum(len(r.tokens) - 1 for r in runs["ar"])
    k1_want = layers * ar_decoded if on_card else 0
    out.update(launches=launches["ar"], ar_decoded=ar_decoded)
    bad = []
    if launches["ar"] != k1_want or any(launches[n] for n in
                                        ("msd", "null", "eager")):
        bad.append(f"K1 launches {launches}, want ar {k1_want} (= {layers} "
                   f"x {ar_decoded} AR tokens decoded), 0 in MSD")
    tie = QWEN_TIE if on_card else 0.0
    check_s = [0.0]

    def check(*a, **kw):
        # the recomputes' seconds, reported apart from the timed runs
        t1 = time.perf_counter()
        r = qwen_token_check(*a, **kw)
        check_s[0] += time.perf_counter() - t1
        return r

    checks, splits = [], []
    for pi, (ids, f, grid_i) in enumerate(prompts):
        toks = {n: runs[n][pi].tokens for n in runs}
        for n, t in toks.items():
            if t.shape != (max_new,) or t.min() < 0 \
                    or t.max() >= lc.vocab_size:
                bad.append(f"prompt {pi} {n}: bad tokens {t.shape}")
        if not (np.array_equal(toks["msd"], toks["null"])
                and np.array_equal(toks["msd"], toks["eager"])):
            bad.append(f"prompt {pi}: MSD, eager MSD and null-draft tokens "
                       f"differ")
        chk = check(gen, ids, f, grid_i, toks["msd"], toks["ar"], tie)
        checks.append(chk)
        if chk["bad"]:
            bad.append(f"prompt {pi}: committed tokens off the mrope "
                       f"recompute's argmax (token, ulps below A's top, "
                       f"allowed, below B's, rank): "
                       f"{chk['bad']}")
        if chk["split"] is not None:
            splits.append(chk["split"])
        if not split_ok(chk["split"], tie):
            bad.append(f"prompt {pi}: AR departs from MSD at a split "
                       f"that is no rounding tie: {chk['split']}")
    out["recompute_worst"] = max(c["worst"] for c in checks)
    out["recompute_noise"] = max(c["noise"] for c in checks)
    log(f"[qwen] on 2 image prompts ({len(ids0)} rows) and 1 text prompt "
        f"({prompt_tokens}) x {max_new} tokens: graph MSD == eager MSD == "
        f"null draft: True; committed MSD tokens off the mrope recompute's "
        f"canonical argmax: {sum(c['off'] for c in checks)} of "
        f"{len(prompts) * max_new} (off the shaped recompute's: "
        f"{sum(c['off_b'] for c in checks)}, allowed 0), worst {out['recompute_worst']:.2f} bf16 "
        f"ulps below its top (allowed {tie:g} + the row's noise); the "
        f"noise against the shaped recompute up to "
        f"{out['recompute_noise']:.2f} ulps; tokens off A's argmax (prompt,"
        f" token, ulps below A's top, noise, below B's, rank): "
        + (", ".join(f"({pi}, {r[0]}, {r[1]:g}, {r[2]:g}, {r[3]:g}, "
                     f"{r[4]})" for pi, c in enumerate(checks)
                     for r in c["rows"]) or "none")
        + f"; AR == MSD up to the first "
        f"split on {len(prompts) - len(splits)} of {len(prompts)}"
        + "".join(f"; split at token {s['at']}: {s['ulps']:.1f} ulps "
                  f"(noise {s['noise']:g}) at |logit| {s['logit']:.4f}, "
                  f"ranks {s['ranks']}" for s in splits)
        + f"; K1 launches {launches} (ar = {layers} x {ar_decoded} AR "
        f"tokens decoded) on {card}")
    if bad:
        raise AssertionError(f"[qwen] {bad}")

    t1 = time.perf_counter()
    out["fault"] = qwen_fault_check(lambda: generator(True), prompts[:2],
                                    runs["msd"][:2], max_new, tie, card)
    out["fault_s"] = time.perf_counter() - t1

    # a training record over the first image prompt (train/data_gen)
    rec = qwen_record_check(gen, qcfg, ids0, f0, g0,
                            QWEN_RECORD_TOL if on_card else 1e-5)
    out["record"] = rec
    log(f"[qwen] training record (make_qwen_record_from_ids) over image "
        f"prompt 0: {rec['rows']} rows padded to {rec['pad']}, JAX's layout,"
        f" hidden rows bitwise a recompute at the record's shape; against "
        f"the unpadded mrope recompute: worst relative row error "
        f"{rec['err']:.3e} (allowed "
        f"{QWEN_RECORD_TOL if on_card else 1e-5:g}); {rec['seconds']:.1f}s "
        f"on {card}")

    # deep acceptance after an image: the oracle tree, on a generator that
    # captures inside the block; the image prompts share one length
    gen_o = gens["oracle"]
    e0 = len(ids0)
    steps_want, hist_want = oracle_schedule(len(widths), max_new)
    full = min(len(widths) + 1, 15)
    ref = torch.zeros(max_new, dtype=torch.int32, device=device)
    with oracle_draft(ref, e0):
        ref.copy_(torch.from_numpy(runs["null"][0].tokens))
        gen_o.generate(ids0, f0, max_new_warm, img_grid=g0)
        n_cap_o = captures(gen_o)
        for pi in (0, 1):
            ids, f, grid_i = prompts[pi]
            want = runs["null"][pi].tokens
            ref.copy_(torch.from_numpy(want))
            r = gen_o.generate(ids, f, max_new, img_grid=grid_i)
            if not (np.array_equal(r.tokens, want)
                    and r.accept_steps == steps_want
                    and r.alpha_hist[full] == hist_want[full]):
                raise AssertionError(
                    f"[qwen] prompt {pi}: the oracle draft was not accepted "
                    f"to full depth or changed the tokens: "
                    f"{r.accept_steps} steps (want {steps_want}), "
                    f"{int(r.alpha_hist[full])} of depth {len(widths)}")
    if captures(gen_o) != n_cap_o:
        raise AssertionError("[qwen] oracle: a capture inside the timed runs")
    log(f"[qwen] oracle draft on the image prompts: accepted to depth "
        f"{len(widths)} at every step ({steps_want} steps), tokens == the "
        f"null draft's")

    # batched lanes: B = 2 over the image prompts, one shared grid
    gen.generate_batch([p[0] for p in prompts[:2]], [f0, f0], max_new_warm,
                       img_grid=g0)
    sync()
    t1 = time.perf_counter()
    batch = gen.generate_batch([p[0] for p in prompts[:2]], [f0, f0],
                               max_new, img_grid=g0)
    sync()
    out["batch_s"] = time.perf_counter() - t1
    solo = [np.array_equal(r.tokens, runs["msd"][b].tokens)
            for b, r in enumerate(batch)]
    if not all(solo):
        raise AssertionError(f"[qwen] generate_batch B=2 lanes != solo "
                             f"runs: {solo}")

    def per(name, unit):
        s = sum(secs[name])
        n = sum(len(r.tokens) if unit == "token" else r.accept_steps
                for r in runs[name])
        return s * 1e3 / max(n, 1)

    out.update(ar_ms=per("ar", "token"), msd_ms_step=per("msd", "step"),
               eager_ms_step=per("eager", "step"),
               null_ms_step=per("null", "step"),
               alpha=np.mean([r.avg_accept_len for r in runs["msd"]]))
    if on_card:
        out["ar_replay_ms"] = _replay_ms(gen, runs["ar"][0].graph)
        out["step_replay_ms"] = _replay_ms(gen, runs["msd"][0].graph)
    else:
        out["ar_replay_ms"] = out["step_replay_ms"] = float("nan")
    log(f"[qwen] generate_batch B=2 (image prompts) == solo runs: True, "
        f"{out['batch_s'] * 1e3 / (2 * max_new):.2f} ms per lane token; "
        f"AR {out['ar_ms']:.2f} ms/token wall incl. prefill, "
        f"{out['ar_replay_ms']:.3f} ms per replayed AR token; MSD "
        f"{out['msd_ms_step']:.2f} ms/step graph, {out['eager_ms_step']:.2f} "
        f"eager, null draft {out['null_ms_step']:.2f} (wall incl. "
        f"prefill), {out['step_replay_ms']:.3f} ms per replayed step, alpha "
        f"{out['alpha']:.3f} on {card}")

    # [video]: 32 frames through the tower, then the adapter's video_gen
    out["video"] = run_video(gen, drafts, vision, vcfg, lc, image_size,
                             max_new, tie, card, n_frames=video_frames)

    # the checkpoint: written, read back bitwise
    ckpt, ddir, ndir = f"{root}/qwen2vl", f"{root}/draft", f"{root}/null"
    t1 = time.perf_counter()
    written = W.save_qwen2_vl(tp, vision, qcfg, vcfg, ckpt, dtype)
    written += os.path.getsize(W.save_draft(drafts["msd"], ddir))
    out["write_s"] = time.perf_counter() - t1
    W.save_draft(drafts["null"], ndir)
    t1 = time.perf_counter()
    lm2, vis2, qcfg2, vcfg2 = W.load_qwen2_vl(ckpt, dtype, device)
    dr2, _ = W.load_draft(ddir, qcfg2.as_llama(),
                          base_embed=lm2["embed_tokens"], dtype=dtype,
                          device=device)
    sync()
    out["load_s"] = time.perf_counter() - t1
    diff = _bitwise_diff("target", _flat_tensors(lm2), _flat_tensors(tp)) \
        + _bitwise_diff("tower", _flat_tensors(vis2),
                        _flat_tensors(vision)) \
        + _bitwise_diff("draft", _flat_tensors(dr2),
                        _flat_tensors(drafts["msd"]))
    if diff or (qcfg2, vcfg2) != (qcfg, vcfg):
        raise AssertionError(f"[qwen] the checkpoint does not load back "
                             f"bitwise: {diff[:8]}")
    del lm2, vis2, dr2
    log(f"[qwen] checkpoint (save_qwen2_vl, bf16 HF layout) + draft "
        f"(save_draft, fp32): {written / 1e9:.3f} GB written in "
        f"{out['write_s']:.1f}s, loaded back bitwise in "
        f"{out['load_s']:.1f}s on {card}")

    # the harness: A (MSD), B (AR), D (null draft) through the CLI's main
    tasks = list(tasks) + list(QWEN_VIDEO_TASKS)
    gen_tasks = [t for t in tasks if t != "ai2d_ppl"]
    n_vid = QWEN_HARNESS_FRAMES // vcfg.temporal_patch_size * gen.n_img
    run = [None]
    reqs, scores, ar_steps = [], [], [0]
    orig = {"generate": MSDGenerator.generate,
            "naive_generate": MSDGenerator.naive_generate,
            "score": MSDGenerator.score, "ar_decode": SE.ar_decode}

    def wrap_gen(kind):
        def wrapped(self, ids, img_feats=None, max_new_tokens=None, **kw):
            before = captures(self)
            k1_0, steps0 = K1.decode_attention.launches, ar_steps[0]
            t1 = time.perf_counter()
            r = orig[kind](self, ids, img_feats, max_new_tokens, **kw)
            sync()
            mine = [q for q in reqs if q["run"] == run[0]]
            rec = {"run": run[0], "task": gen_tasks[len(mine) // limit],
                   "t": (t1, time.perf_counter()), "n": len(r.tokens),
                   "tokens": r.tokens.tolist(),
                   "captured": captures(self) - before,
                   "k1": K1.decode_attention.launches - k1_0,
                   "ar_steps": ar_steps[0] - steps0,
                   "video": (self.n_img, bool(np.isin(ids,
                                                      VIDEO_PAD_ID).any())),
                   "key": (kind, max_new_tokens, kw.get("sp"), self.n_img)}
            if run[0] == "A":
                rec["check"] = check(self, ids, img_feats,
                                     kw.get("img_grid"), r.tokens, tie=tie)
            if run[0] == "B":
                a = [q for q in reqs if q["run"] == "A"][len(mine)]
                rec["split"] = check(
                    self, ids, img_feats, kw.get("img_grid"), a["tokens"],
                    r.tokens, tie)["split"]
            reqs.append(rec)
            return r
        return wrapped

    def score(self, ids, cont_start, img_feats=None, img_grid=None):
        t1 = time.perf_counter()
        got = orig["score"](self, ids, cont_start, img_feats, img_grid)
        sync()
        rec = {"run": run[0], "task": "ai2d_ppl", "out": got,
               "t": (t1, time.perf_counter())}
        if run[0] == "A":
            rec["again"] = orig["score"](self, ids, cont_start, img_feats,
                                         img_grid)
            rec["plain"] = qwen_plain_score(self, ids, cont_start, img_feats,
                                            img_grid)
        scores.append(rec)
        return got

    def ar_decode(*a, **kw):
        n = orig["ar_decode"](*a, **kw)
        ar_steps[0] += n - 1
        return n

    margs = (f"pretrained={ckpt},max_seq_len={max_seq},"
             f"max_num_frames={QWEN_HARNESS_FRAMES}")
    common = ["--model", "qwen2_vl_msd", "--model_args", margs,
              "--device", str(device), "--limit", str(limit),
              "--gen_kwargs", f"max_new_tokens={harness_new}",
              "--log_samples"]
    hruns = {"A": ["--use_msd", "--msd_model_path", ddir,
                   "--tasks", ",".join(tasks)],
             "B": ["--msd_model_path", ddir, "--tasks", ",".join(tasks)],
             "D": ["--use_msd", "--msd_model_path", ndir,
                   "--tasks", ",".join(gen_tasks)]}
    MSDGenerator.generate = wrap_gen("generate")
    MSDGenerator.naive_generate = wrap_gen("naive_generate")
    MSDGenerator.score = score
    SE.ar_decode = ar_decode
    try:
        for name, argv in hruns.items():
            run[0] = name
            steps0 = ar_steps[0]
            K1.decode_attention.launches = 0
            t1 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                payload = HM.main(argv + common)
            sync()
            out[name] = {"payload": payload, "s": time.perf_counter() - t1,
                         "launches": K1.decode_attention.launches,
                         "ar_steps": ar_steps[0] - steps0}
            gc.collect()
            if on_card:
                torch.cuda.empty_cache()
    finally:
        MSDGenerator.generate = orig["generate"]
        MSDGenerator.naive_generate = orig["naive_generate"]
        MSDGenerator.score = orig["score"]
        SE.ar_decode = orig["ar_decode"]

    def of(name, task=None):
        return [r for r in reqs if r["run"] == name
                and task in (None, r["task"])]

    def responses(name, task):
        return [s["response"] for s in
                out[name]["payload"]["details"][task]["samples"]]

    bad = [f"{n} ran {len(of(n))} generate requests" for n in hruns
           if len(of(n)) != limit * len(gen_tasks)]
    if bad:
        raise AssertionError(f"[qwen] {bad}")
    for t in gen_tasks:
        if responses("A", t) != responses("D", t) or \
                [r["tokens"] for r in of("A", t)] != \
                [r["tokens"] for r in of("D", t)]:
            bad.append(f"A != D (null draft) on {t}")
    hbad = [(r["task"], r["check"]["bad"]) for r in of("A")
            if r["check"]["bad"]]
    if hbad:
        bad.append(f"A's tokens off the mrope recompute: {hbad}")
    hsplits = [r["split"] for r in of("B") if r["split"] is not None]
    if not all(split_ok(sp, tie) for sp in hsplits):
        bad.append(f"B departs from A at a split that is no rounding tie: "
                   f"{hsplits}")
    if "ai2d_ppl" in tasks and responses("B", "ai2d_ppl") != \
            responses("A", "ai2d_ppl"):
        bad.append("B's loglikelihoods != A's (bitwise)")
    a_scores = [r for r in scores if r["run"] == "A"]
    if any(r["again"] != r["out"] for r in a_scores):
        bad.append("score is not bitwise repeatable")
    worst = max((abs(r["out"][0] - r["plain"][0])
                 / max(1.0, abs(r["plain"][0])) for r in a_scores),
                default=0.0)
    if worst > 1e-4 or any(r["out"][1] != r["plain"][1] for r in a_scores):
        bad.append(f"score != its mrope recompute (worst relative "
                   f"{worst:.3e} against 1e-4, or a greedy flag)")
    b_caps = sum(r["captured"] for r in of("B"))
    hk1_want = layers * (out["B"]["ar_steps"] + WARMUP_STEPS * b_caps) \
        if on_card else 0
    if out["B"]["launches"] != hk1_want or out["A"]["launches"] \
            or out["D"]["launches"]:
        bad.append(f"K1 launches A {out['A']['launches']}, B "
                   f"{out['B']['launches']} (want {hk1_want}), D "
                   f"{out['D']['launches']}")
    k1_off = [(r["task"], r["k1"]) for r in of("B") if r["k1"] != (
        layers * (r["ar_steps"] + WARMUP_STEPS * r["captured"])
        if on_card else 0)]
    if k1_off:
        bad.append(f"B's requests' K1 launches != layers x (AR tokens + "
                   f"warm-up steps): {k1_off}")
    # the video docs, and only they, on video_gen
    on_vgen = {n: [r["task"] for r in of(n) if r["video"] == (n_vid, True)]
               for n in hruns}
    want_v = [t for t in QWEN_VIDEO_TASKS for _ in range(limit)]
    if any(v != want_v for v in on_vgen.values()) or any(
            r["video"] != (gen.n_img, False) for n in hruns for r in of(n)
            if r["task"] not in QWEN_VIDEO_TASKS):
        bad.append(f"video_gen ran {on_vgen}, want {want_v} in each run")
    seen, late = set(), []
    for r in reqs:
        k = (r["run"],) + r["key"]
        if k in seen and r["captured"]:
            late.append((r["run"], r["task"]))
        seen.add(k)
    if late:
        bad.append(f"graphs captured inside later requests: {late}")

    def ms_per_token(name, task=None):
        rs = of(name, task)
        return 1e3 * sum(r["t"][1] - r["t"][0] for r in rs) \
            / max(1, sum(r["n"] for r in rs))

    spans = {}
    for r in reqs + scores:
        lo, hi = spans.get((r["run"], r["task"]), r["t"])
        spans[(r["run"], r["task"])] = (min(lo, r["t"][0]),
                                        max(hi, r["t"][1]))
    out.update(harness_launches=out["B"]["launches"],
               harness_ar_steps=out["B"]["ar_steps"], harness_caps=b_caps,
               worst_score_rel=worst, harness_splits=hsplits,
               ms_token={n: ms_per_token(n) for n in hruns},
               task_s={k: hi - lo for k, (lo, hi) in spans.items()},
               task_ms_token={(n, t): ms_per_token(n, t) for n in hruns
                              for t in gen_tasks},
               k1_by_task={t: sum(r["k1"] for r in of("B", t))
                           for t in gen_tasks},
               video_gen_requests={n: len(v) for n, v in on_vgen.items()},
               peak=torch.cuda.max_memory_allocated() if on_card else 0,
               seconds=time.perf_counter() - t_phase)
    log(f"[qwen] harness (--model qwen2_vl_msd, {limit} synthetic docs per "
        f"task, {harness_new} new tokens, {QWEN_HARNESS_FRAMES} frames per "
        f"video): A (MSD) {out['A']['s']:.1f}s, B "
        f"(AR) {out['B']['s']:.1f}s, D (null draft) {out['D']['s']:.1f}s; "
        f"seconds per task: " + "; ".join(
            f"{r}/{t} {s:.2f}" for (r, t), s in out["task_s"].items())
        + "; ms per generated token (prefill included): " + "; ".join(
            f"{r}/{t} {v:.2f}" for (r, t), v in
            out["task_ms_token"].items())
        + f"; K1 in B by task {out['k1_by_task']}; video_gen requests "
        f"{out['video_gen_requests']} ({n_vid} video rows each) on {card}")
    log(f"[qwen] harness: A == D responses and token ids on {gen_tasks}: "
        f"True; A's tokens off the mrope recompute's canonical argmax: "
        f"{sum(r['check']['off'] for r in of('A'))}, worst "
        f"{max(r['check']['worst'] for r in of('A')):.2f} ulps (allowed "
        f"{tie:g} + the row's noise, up to "
        f"{max(r['check']['noise'] for r in of('A')):.2f}), off the shaped "
        f"recompute's: {sum(r['check']['off_b'] for r in of('A'))} "
        f"(allowed 0); off A's argmax (request, token, ulps below A's top, "
        f"noise, below B's, rank): " + (", ".join(
            f"({i}, {r[0]}, {r[1]:g}, {r[2]:g}, {r[3]:g}, {r[4]})"
            for i, q in enumerate(of("A")) for r in q["check"]["rows"])
            or "none")
        + "; B == A up to each first split ("
        + ("; ".join(f"token {s['at']}, {s['ulps']:.1f} ulps (noise "
                     f"{s['noise']:g}), ranks {s['ranks']}"
                     for s in hsplits) or "no split")
        + f"); ai2d_ppl A == B bitwise, repeat bitwise, recompute worst "
        f"relative {worst:.3e}; ms per generated token (prefill included) "
        f"A {out['ms_token']['A']:.2f}, B {out['ms_token']['B']:.2f}, D "
        f"{out['ms_token']['D']:.2f}; K1 in B {out['B']['launches']} = "
        f"{layers} x ({out['B']['ar_steps']} AR tokens decoded + "
        f"{WARMUP_STEPS} warm-up steps x {b_caps} capture), 0 in A, D on "
        f"{card}")
    if bad:
        raise AssertionError(f"[qwen] {bad}")
    log(f"[qwen] peak {out['peak'] / 2**30:.2f} GiB allocated; phase "
        f"{out['seconds']:.1f}s, of which the recompute checks "
        f"{check_s[0]:.1f}s and the planted fault {out['fault_s']:.1f}s on "
        f"{card}")
    del gens, gen, gen_o
    return out


def v1_logits_fn(gen, ids, feats, pad_ids=None):
    """``logits(toks, chunk=None)`` of ``token_check`` for a Qwen-VL (v1)
    prompt: its inline span's rows (from the first id of ``pad_ids``,
    default v1's ``<imgpad>``) replaced by ``feats`` by concatenation,
    apart from the engine's fusion and its ``_img_pos``, at 1-D positions
    (``rows_logits_fn``)."""
    import torch

    ids = np.asarray(ids, np.int64)
    table, dev = gen.params["target"]["embed_tokens"], gen.device

    def embed(x):
        return table[torch.from_numpy(
            np.clip(x, 0, table.shape[0] - 1)).to(dev)]

    if feats is None:
        prompt = embed(ids)
    else:
        start = int(np.argmax(np.isin(ids, pad_ids or (V1_IMG_PAD,))))
        prompt = torch.cat([embed(ids[:start]), feats.to(table.dtype),
                            embed(ids[start + len(feats):])])
    return rows_logits_fn(gen, prompt)


def v1_plain_score(gen, ids, cont_start: int, feats, pad_ids=None) -> tuple:
    """The plain recompute of a v1 ``MSDGenerator.score``: the unpadded
    ``v1_logits_fn`` rows of the continuation, ``log_softmax`` and a
    gather. Returns (logprob_sum, is_greedy)."""
    import torch

    ids = np.asarray(ids, np.int64)
    cont = ids[cont_start:]
    rows = v1_logits_fn(gen, ids[:cont_start], feats, pad_ids)(cont)
    logp = torch.log_softmax(rows[:len(cont)], dim=-1)
    nxt = torch.from_numpy(cont).to(gen.device)
    return (float(logp.gather(1, nxt[:, None]).sum()),
            bool((logp.argmax(dim=-1) == nxt).all()))


def prefill_row(gen, ids, feats):
    """The engine's fp32 logits of a request's first new token, as its AR
    prefill hands them to ``sample_token`` (a one-token
    ``naive_generate``; a wrapper records the first call)."""
    from msd_tpu_torch.engine import spec_engine as SE

    rows, orig = [], SE.sample_token

    def spy(logits, *a, **kw):
        if not rows:
            rows.append(logits.float().clone())
        return orig(logits, *a, **kw)

    SE.sample_token = spy
    try:
        gen.naive_generate(ids, feats, 1)
    finally:
        SE.sample_token = orig
    return rows[0]


def row_gap(row, ref) -> float:
    """max |row - ref| over a logits row, in bf16 ulps of ref's largest
    magnitude."""
    return float((row - ref).abs().max() / bf16_ulp(ref.abs().max()))


def v1_tower_without_key_positions(vision, vcfg, px):
    """The planted fault (b) of ``[qwen_v1]``: the v1 tower whose
    resampler's keys lack their interpolated positional table (the same
    ViT, queries, values and projection otherwise)."""
    from msd_tpu_torch.models import qwen_vl_v1 as QV1
    from msd_tpu_torch.ops.norms import layer_norm

    x = QV1.qwen_vl_vit(vision, vcfg, px)
    r, eps = vision["resampler"], vcfg.layer_norm_eps
    kv = layer_norm(x @ r["kv_proj_w"].T, r["ln_kv_w"], r["ln_kv_b"], eps)
    q = layer_norm(r["query"], r["ln_q_w"], r["ln_q_b"], eps)
    out = QV1._mha(q + r["pos_embed"], kv, kv, r["attn"],
                   vcfg.resampler_heads)
    out = layer_norm(out, vision["ln_post_w"], vision["ln_post_b"], eps)
    return out @ vision["proj"]


def v1_tower_replica(vision, vcfg, px):
    """The v1 tower as the public remote code writes it, apart from
    ``models/qwen_vl_v1``: ``conv2d`` patches, ``get_abs_pos`` by
    ``F.interpolate`` (bicubic), ``F.layer_norm``, the blocks and the
    resampler through ``F.multi_head_attention_forward`` (sequence-first,
    one batch), ``F.gelu``. [3, H, W] -> [n_queries, output_dim]."""
    import torch.nn.functional as F

    p, eps = vcfg.patch_size, vcfg.layer_norm_eps
    dt = vision["conv1"].dtype

    def abs_pos(pos, n):
        src, tgt = int(round(pos.shape[0] ** 0.5)), int(round(n ** 0.5))
        if src == tgt:
            return pos
        grid = pos.float().reshape(1, src, src, -1).permute(0, 3, 1, 2)
        return F.interpolate(grid, size=(tgt, tgt), mode="bicubic",
                             align_corners=False).permute(0, 2, 3, 1) \
            .flatten(0, 2).to(pos.dtype)

    def ln(x, w, b):
        return F.layer_norm(x, x.shape[-1:], w, b, eps)

    def mha(q, k, v, a, heads):
        e = q.shape[-1]
        return F.multi_head_attention_forward(
            q[:, None], k[:, None], v[:, None], e, heads, a["in_proj_w"],
            a["in_proj_b"], None, None, False, 0.0, a["out_proj_w"],
            a["out_proj_b"], training=False, need_weights=False)[0][:, 0]

    x = F.conv2d(px.to(dt)[None], vision["conv1"].reshape(-1, 3, p, p),
                 stride=p)
    x = x.flatten(2).transpose(1, 2)[0]
    x = ln(x + abs_pos(vision["pos_embed"], x.shape[0]),
           vision["ln_pre_w"], vision["ln_pre_b"])
    b = vision["blocks"]
    for i in range(vcfg.layers):
        y = ln(x, b["ln1_w"][i], b["ln1_b"][i])
        x = x + mha(y, y, y, {k: t[i] for k, t in b.items()}, vcfg.heads)
        y = ln(x, b["ln2_w"][i], b["ln2_b"][i])
        y = F.gelu(F.linear(y, b["fc_w"][i], b["fc_b"][i]))
        x = x + F.linear(y, b["proj_w"][i], b["proj_b"][i])
    r = vision["resampler"]
    kv = ln(F.linear(x, r["kv_proj_w"]), r["ln_kv_w"], r["ln_kv_b"])
    q = ln(r["query"], r["ln_q_w"], r["ln_q_b"])
    out = mha(q + r["pos_embed"], kv + abs_pos(r["pos_embed"], kv.shape[0]),
              kv, r["attn"], vcfg.resampler_heads)
    return ln(out, vision["ln_post_w"], vision["ln_post_b"]) @ vision["proj"]


def hf_qwen_vl_v1_state(lm, vision, vcfg) -> dict:
    """The public Qwen/Qwen-VL checkpoint names of a v1 LM and tower (the
    inverse of ``load_qwen_vl_v1``'s importers): the fused ``c_attn`` of
    each layer concatenated from q/k/v and their biases, the [in, out]
    weights transposed back, the tower's blocks unstacked and ``conv1``
    as [width, 3, P, P]."""
    import torch

    L_ = lm["layers"]
    st = {"transformer.wte.weight": lm["embed_tokens"],
          "transformer.ln_f.weight": lm["norm"],
          "lm_head.weight": lm["lm_head"].T}
    for i in range(L_["q_proj"].shape[0]):
        pre = f"transformer.h.{i}."
        st[pre + "attn.c_attn.weight"] = torch.cat(
            [L_[f"{x}_proj"][i] for x in "qkv"])
        st[pre + "attn.c_attn.bias"] = torch.cat(
            [L_[f"{x}_bias"][i] for x in "qkv"])
        st[pre + "attn.c_proj.weight"] = L_["o_proj"][i].T
        st[pre + "ln_1.weight"] = L_["input_layernorm"][i]
        st[pre + "ln_2.weight"] = L_["post_attention_layernorm"][i]
        st[pre + "mlp.w2.weight"] = L_["gate_proj"][i].T
        st[pre + "mlp.w1.weight"] = L_["up_proj"][i].T
        st[pre + "mlp.c_proj.weight"] = L_["down_proj"][i].T
    v = "transformer.visual."
    p = vcfg.patch_size
    st[v + "conv1.weight"] = vision["conv1"].reshape(vcfg.width, 3, p, p)
    st[v + "positional_embedding"] = vision["pos_embed"]
    st[v + "ln_pre.weight"] = vision["ln_pre_w"]
    st[v + "ln_pre.bias"] = vision["ln_pre_b"]
    names = {"ln1_w": "ln_1.weight", "ln1_b": "ln_1.bias",
             "ln2_w": "ln_2.weight", "ln2_b": "ln_2.bias",
             "in_proj_w": "attn.in_proj_weight",
             "in_proj_b": "attn.in_proj_bias",
             "out_proj_w": "attn.out_proj.weight",
             "out_proj_b": "attn.out_proj.bias",
             "fc_w": "mlp.c_fc.weight", "fc_b": "mlp.c_fc.bias",
             "proj_w": "mlp.c_proj.weight", "proj_b": "mlp.c_proj.bias"}
    for i in range(vcfg.layers):
        for ours, theirs in names.items():
            st[f"{v}transformer.resblocks.{i}.{theirs}"] = \
                vision["blocks"][ours][i]
    r, a = vision["resampler"], v + "attn_pool."
    st.update({a + "pos_embed": r["pos_embed"], a + "query": r["query"],
               a + "kv_proj.weight": r["kv_proj_w"],
               a + "ln_q.weight": r["ln_q_w"], a + "ln_q.bias": r["ln_q_b"],
               a + "ln_kv.weight": r["ln_kv_w"],
               a + "ln_kv.bias": r["ln_kv_b"],
               a + "attn.in_proj_weight": r["attn"]["in_proj_w"],
               a + "attn.in_proj_bias": r["attn"]["in_proj_b"],
               a + "attn.out_proj.weight": r["attn"]["out_proj_w"],
               a + "attn.out_proj.bias": r["attn"]["out_proj_b"],
               v + "ln_post.weight": vision["ln_post_w"],
               v + "ln_post.bias": vision["ln_post_b"],
               v + "proj": vision["proj"]})
    return st


def save_qwen_vl_v1(lm, vision, tcfg, vcfg, path: str, dtype) -> int:
    """Write a v1 LM and tower as the checkpoint ``load_qwen_vl_v1``
    reads: ``hf_qwen_vl_v1_state`` in safetensors shards (the port's
    ``weights._save_shards`` over ``safetensors_io.save_file``) and a
    ``config.json`` in the public model's names (``intermediate_size`` the
    w1 + w2 width, ``layer_norm_epsilon``, ``rotary_emb_base``, the
    ``visual`` block with its ``image_start_id``). Returns the bytes
    written."""
    from msd_tpu_torch.utils import weights as W

    written = W._save_shards(hf_qwen_vl_v1_state(lm, vision, vcfg), path,
                             dtype)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({
            "architectures": ["QWenLMHeadModel"], "model_type": "qwen",
            "vocab_size": tcfg.vocab_size, "hidden_size": tcfg.hidden_size,
            "intermediate_size": 2 * tcfg.intermediate_size,
            "num_hidden_layers": tcfg.num_hidden_layers,
            "num_attention_heads": tcfg.num_attention_heads,
            "max_position_embeddings": tcfg.max_position_embeddings,
            "layer_norm_epsilon": tcfg.rms_norm_eps,
            "rotary_emb_base": tcfg.rope_theta,
            "visual": {"image_size": vcfg.image_size,
                       "patch_size": vcfg.patch_size, "width": vcfg.width,
                       "layers": vcfg.layers, "heads": vcfg.heads,
                       "mlp_size": vcfg.mlp_size,
                       "output_dim": vcfg.output_dim,
                       "n_queries": vcfg.n_queries,
                       "image_start_id": V1_IMG_START},
            "torch_dtype": str(dtype).split(".")[-1]}, f, indent=1)
    return written


def run_qwen_v1(root: str, device="cuda", qcfg=None, vcfg=None,
                widths=WIDTHS, max_seq: int = MAX_SEQ,
                max_new: int = QWEN_NEW,
                prompt_tokens: int = PROMPT_TOKENS, limit: int = QWEN_LIMIT,
                harness_new: int = HARNESS_NEW, tasks=V1_HARNESS_TASKS,
                max_new_warm: int = 4) -> dict:
    """Qwen-VL (v1) at full width (``qcfg``/``vcfg`` cut it for the CPU):
    the Qwen-1 decoder (32 layers, hidden 4096, 32 heads, no GQA, vocab
    151936, 1-D rope, q/k/v biases drawn at std ``QWEN_BIAS_STD``, bf16
    weights, fp32 residual, ``lm_head`` x6), the ViT-bigG tower with its
    256-query resampler (48 x 1664), a 13-head medusa draft and a null
    draft at the decoder's width, all from seeded generators on the
    device; a seeded 448px image through the tower (256 rows); two image
    prompts (``prompt_tokens`` text tokens around the v1 span <img>
    <imgpad> x 256 </img>, ids 151857, 151859, 151858: found only through
    ``inline_pad_ids``) and one text prompt, each x ``max_new`` tokens, 6
    canonical rounding bits, the main path's tree.

    Generator runs: graph MSD, eager MSD, graph null-draft MSD and graph
    ``naive_generate`` (AR). Then the checkpoint in the public names
    (``save_qwen_vl_v1``; ``save_draft``) under ``root``, read back by
    ``load_qwen_vl_v1``, and ``harness.__main__.main`` in process with
    ``--model qwen_vl_eagle``: B its default (AR), A ``--use_msd``.

    Fails unless: graph MSD == eager MSD == the null draft, bitwise, on
    every prompt; every committed MSD (and A) token passes ``token_check``
    against the v1 recompute (``v1_logits_fn``: the span spliced in by
    concatenation, 1-D positions), exactly at the verify's row shapes and,
    unpadded, its canonical argmax or on the card within ``QWEN_TIE`` bf16
    ulps plus the row's noise; AR (and B) equals MSD (and A) up to each
    first split, each split such a tie; K1 launches layers x AR tokens
    decoded in the AR runs and in B (a capture's warm-up steps included),
    0 in every MSD run; the ai2d_ppl scores bitwise equal across A and B
    and within 1e-4 (relative, floor 1) of their recompute; the loaded
    checkpoint bitwise the weights in memory; the bf16 tower within
    ``V1_TOWER_TOL`` (relative L2) of its fp32 evaluation on the device;
    and both planted faults rejected on a measured quantity: (a) a
    generator without ``inline_pad_ids`` (the span is not found, so no
    image row is fused), by its first decode row's logits against the
    recompute beyond the true generator's gap on the same row (plus
    ``QWEN_TIE`` ulps on the card); (b) the resampler's keys without
    their positional table, by the tower's error beyond ``V1_TOWER_TOL``
    and by that row's gap with the faulty rows. On the card K1 is timed at
    the phase's AR row (``time_k1_row``)."""
    import io

    import torch
    from msd_tpu_torch.configs import DraftConfig, EngineConfig, TreeConfig
    from msd_tpu_torch.engine import spec_engine as SE
    from msd_tpu_torch.engine.generator import MSDGenerator
    from msd_tpu_torch.engine.graphs import WARMUP_STEPS
    from msd_tpu_torch.harness import __main__ as HM
    from msd_tpu_torch.models import draft as D
    from msd_tpu_torch.models import llama as L
    from msd_tpu_torch.models.qwen_vl_v1 import (
        QwenVLV1TextConfig, QwenVLVisionConfig, init_qwen_vl_vision_params,
        qwen_vl_vision_encode)
    from msd_tpu_torch.ops import decode_attention as K1
    from msd_tpu_torch.ops.sampling import SamplingParams
    from msd_tpu_torch.utils import weights as W
    from msd_tpu_torch.utils.mm_utils import process_image

    on_card = str(device).startswith("cuda")
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    dtype = torch.bfloat16 if on_card else torch.float32
    card = smi_name_and_limit() if on_card else "cpu"
    tie = QWEN_TIE if on_card else 0.0
    tower_tol = V1_TOWER_TOL if on_card else 1e-5
    t_phase = time.perf_counter()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    qcfg = qcfg or QwenVLV1TextConfig()
    vcfg = vcfg or QwenVLVisionConfig(output_dim=qcfg.hidden_size)
    lc = dataclasses.replace(qcfg.as_llama(), residual_dtype="float32")
    g = torch.Generator(device=device).manual_seed(16)
    tp = L.init_llama_params(lc, g, device, dtype)
    for name in ("q_bias", "k_bias", "v_bias"):   # no GQA: all of width H
        tp["layers"][name] = torch.empty(
            lc.num_hidden_layers, lc.hidden_size, dtype=dtype,
            device=device).normal_(0.0, QWEN_BIAS_STD, generator=g)
    tp["lm_head"].mul_(HEAD_SHARPEN)
    dcfg = DraftConfig(text=lc, medusa_heads=len(widths) - 1)
    drafts = {}
    for name in ("msd", "null"):
        dp = D.init_draft_params(dcfg, g, device, dtype)
        dp["medusa"] = D.init_medusa_params(dcfg, g, device, dtype)
        dp["embed_tokens"] = tp["embed_tokens"]
        drafts[name] = dp
    vision = init_qwen_vl_vision_params(vcfg, g, device, dtype)
    sync()
    out = {"card": card, "init_s": time.perf_counter() - t_phase}
    n_tower = sum(t.numel() for t in _flat_tensors(vision).values())
    log(f"[qwen_v1] Qwen-VL (v1) width: {lc.num_hidden_layers} layers, "
        f"hidden {lc.hidden_size}, {lc.num_attention_heads} heads (no GQA), "
        f"vocab {lc.vocab_size}, 1-D rope, q/k/v biases; target "
        f"{_weight_bytes(tp) / 1e9:.2f} GB "
        f"({sum(t.numel() for t in _flat_tensors(tp).values()) / 1e9:.3f}G "
        f"parameters); tower {vcfg.layers} x {vcfg.width} with a "
        f"{vcfg.n_queries}-query resampler, {_weight_bytes(vision) / 1e9:.2f}"
        f" GB ({n_tower / 1e9:.3f}G parameters); initialised on {device} in "
        f"{out['init_s']:.1f}s on {card}")

    # the image through the tower: its rows feed every image request
    n_img = vcfg.n_queries
    rng = np.random.default_rng(16)
    image = rng.integers(0, 256, size=(vcfg.image_size, vcfg.image_size, 3),
                         dtype=np.uint8)
    px = torch.from_numpy(process_image(image, vcfg.image_size)).to(device)
    feats = qwen_vl_vision_encode(vision, vcfg, px)
    sync()
    t1 = time.perf_counter()
    for _ in range(3):
        feats = qwen_vl_vision_encode(vision, vcfg, px)
    sync()
    out["tower_ms"] = (time.perf_counter() - t1) * 1e3 / 3
    # fp32 evaluations of the same weights: the port's tower, the
    # independent replica and the planted fault (b)
    v32 = _map_tensors(vision, lambda t: t.float())
    ref = qwen_vl_vision_encode(v32, vcfg, px)
    replica = v1_tower_replica(v32, vcfg, px)
    bad32 = v1_tower_without_key_positions(v32, vcfg, px)
    del v32
    bad_feats = v1_tower_without_key_positions(vision, vcfg, px)

    def rel(x, y):
        return float((x.float() - y).norm() / y.norm())

    out.update(tower_rel=rel(feats, ref), replica_rel=rel(ref, replica),
               fault_b_rel=rel(bad32, replica),
               fault_b_bf16_rel=rel(bad_feats, ref))
    del bad32, replica
    if tuple(feats.shape) != (n_img, lc.hidden_size) \
            or not torch.isfinite(feats).all():
        raise AssertionError(f"[qwen_v1] tower output {tuple(feats.shape)}, "
                             f"finite {bool(torch.isfinite(feats).all())}")
    if not (out["tower_rel"] <= tower_tol
            and out["replica_rel"] <= V1_REPLICA_TOL < out["fault_b_rel"]):
        raise AssertionError(
            f"[qwen_v1] tower: {dtype} against its fp32 evaluation "
            f"{out['tower_rel']:.3e} (allowed {tower_tol:g}); fp32 against "
            f"the replica {out['replica_rel']:.3e} (allowed "
            f"{V1_REPLICA_TOL:g}); the planted fault (b), keys without "
            f"positions, {out['fault_b_rel']:.3e} off the replica (must "
            f"exceed {V1_REPLICA_TOL:g})")
    log(f"[qwen_v1] tower: {vcfg.image_size}x{vcfg.image_size} image, "
        f"{vcfg.grid}x{vcfg.grid} patches resampled to {n_img} rows, "
        f"{out['tower_ms']:.2f} ms per image ({dtype}); relative error "
        f"against its fp32 evaluation {out['tower_rel']:.3e} (allowed "
        f"{tower_tol:g}); the fp32 evaluation against the remote code's "
        f"replica (F.conv2d, F.interpolate, F.multi_head_attention_forward) "
        f"{out['replica_rel']:.3e} (allowed {V1_REPLICA_TOL:g}); planted "
        f"fault (b), the resampler's keys without their positions: "
        f"{out['fault_b_rel']:.3e} off the replica in fp32, rejected "
        f"({out['fault_b_bf16_rel']:.3e} off the fp32 tower in {dtype}) on "
        f"{card}")

    vocab_hi = min(151000, lc.vocab_size - 1)
    span = (V1_IMG_START, V1_IMG_PAD, V1_IMG_END)
    prompts = [(qwen_prompt(rng, prompt_tokens, n_img, vocab_hi, True, span),
                feats),
               (qwen_prompt(rng, prompt_tokens, n_img, vocab_hi, True, span),
                feats),
               (qwen_prompt(rng, prompt_tokens, n_img, vocab_hi, False),
                None)]
    tree = TreeConfig(top_k=widths[0], max_depth=len(widths),
                      num_nodes=1 + sum(widths), medusa_widths=tuple(widths))
    eng = EngineConfig(max_seq_len=max_seq, prompt_pad_multiple=128,
                       tree=tree)

    def generator(cuda_graphs, pad_ids=(V1_IMG_PAD,)):
        return MSDGenerator(tp, drafts["msd"], lc, dcfg, eng, n_img=n_img,
                            eos_id=-1,
                            sp=SamplingParams(greedy_round_bits=ROUND_BITS),
                            image_mode="inline", mrope_section=None,
                            device=device, cuda_graphs=cuda_graphs,
                            inline_pad_ids=pad_ids)

    gens = {"graph": generator(True), "eager": generator(False)}

    def captures(gen):
        return 0 if gen.graphs is None else len(gen.graphs.steps)

    # warm-up outside the timed window: one capture per step and draft
    ids0, f0 = prompts[0]
    gen = gens["graph"]
    gen.naive_generate(ids0, f0, max_new_warm)
    for name in ("null", "msd"):
        gen.params["draft"] = drafts[name]
        gen.generate(ids0, f0, max_new_warm)
    gens["eager"].generate(ids0, f0, max_new_warm)
    sync()
    n_cap = captures(gen)
    runs, secs, launches = {}, {}, {}
    for ids, f in prompts:
        for name in ("ar", "msd", "null", "eager"):
            gen = gens["eager" if name == "eager" else "graph"]
            gen.params["draft"] = drafts["null" if name == "null" else "msd"]
            # the counts of this path: zeroed just before, read just after
            K1.decode_attention.launches = 0
            t1 = time.perf_counter()
            r = gen.naive_generate(ids, f, max_new) if name == "ar" \
                else gen.generate(ids, f, max_new)
            sync()
            secs.setdefault(name, []).append(time.perf_counter() - t1)
            launches[name] = launches.get(name, 0) + \
                K1.decode_attention.launches
            runs.setdefault(name, []).append(r)
            if gen.graphs is not None and not gen.graphs.reads(r.graph,
                                                               gen.params):
                raise AssertionError(f"[qwen_v1] {name}: replayed a graph "
                                     f"captured for other weights")
    gen = gens["graph"]
    gen.params["draft"] = drafts["msd"]
    if captures(gen) != n_cap or captures(gens["eager"]):
        raise AssertionError("[qwen_v1] a capture inside the timed runs")
    layers = lc.num_hidden_layers
    ar_decoded = sum(len(r.tokens) - 1 for r in runs["ar"])
    k1_want = layers * ar_decoded if on_card else 0
    out.update(launches=launches["ar"], ar_decoded=ar_decoded)
    bad = []
    if launches["ar"] != k1_want or any(launches[n] for n in
                                        ("msd", "null", "eager")):
        bad.append(f"K1 launches {launches}, want ar {k1_want} (= {layers} "
                   f"x {ar_decoded} AR tokens decoded), 0 in MSD")
    check_s = [0.0]

    def check(gen_, ids, f, toks, other=None, pad_ids=None):
        # the recomputes' seconds, reported apart from the timed runs
        t1 = time.perf_counter()
        r = token_check(gen_, v1_logits_fn(gen_, ids, f, pad_ids), toks,
                        other, tie)
        check_s[0] += time.perf_counter() - t1
        return r

    checks, splits = [], []
    for pi, (ids, f) in enumerate(prompts):
        toks = {n: runs[n][pi].tokens for n in runs}
        for n, t in toks.items():
            if t.shape != (max_new,) or t.min() < 0 \
                    or t.max() >= lc.vocab_size:
                bad.append(f"prompt {pi} {n}: bad tokens {t.shape}")
        if not (np.array_equal(toks["msd"], toks["null"])
                and np.array_equal(toks["msd"], toks["eager"])):
            bad.append(f"prompt {pi}: MSD, eager MSD and null-draft tokens "
                       f"differ")
        chk = check(gen, ids, f, toks["msd"], toks["ar"])
        checks.append(chk)
        if chk["bad"]:
            bad.append(f"prompt {pi}: committed tokens off the v1 "
                       f"recompute (token, ulps below A's top, allowed, "
                       f"below B's, rank): {chk['bad']}")
        if chk["split"] is not None:
            splits.append(chk["split"])
        if not split_ok(chk["split"], tie):
            bad.append(f"prompt {pi}: AR departs from MSD at a split that "
                       f"is no rounding tie: {chk['split']}")
    out["recompute_worst"] = max(c["worst"] for c in checks)
    out["recompute_noise"] = max(c["noise"] for c in checks)
    log(f"[qwen_v1] on 2 image prompts ({len(ids0)} rows, the span found "
        f"by inline_pad_ids ({V1_IMG_PAD},)) and 1 text prompt "
        f"({prompt_tokens}) x {max_new} tokens: graph MSD == eager MSD == "
        f"null draft: {not any('differ' in b for b in bad)}; committed MSD "
        f"tokens off the v1 recompute's canonical argmax: "
        f"{sum(c['off'] for c in checks)} of {len(prompts) * max_new} (off "
        f"the shaped recompute's: {sum(c['off_b'] for c in checks)}, "
        f"allowed 0), worst {out['recompute_worst']:.2f} bf16 ulps below "
        f"its top (allowed {tie:g} + the row's noise, up to "
        f"{out['recompute_noise']:.2f}); AR == MSD up to the first split on "
        f"{len(prompts) - len(splits)} of {len(prompts)}"
        + "".join(f"; split at token {s['at']}: {s['ulps']:.1f} ulps "
                  f"(noise {s['noise']:g}) at |logit| {s['logit']:.4f}, "
                  f"ranks {s['ranks']}" for s in splits)
        + f"; K1 launches {launches} (ar = {layers} x {ar_decoded} AR "
        f"tokens decoded) on {card}")
    if bad:
        raise AssertionError(f"[qwen_v1] {bad}")

    # the planted faults, judged on the first decode row's logits against
    # the recompute, beyond the true generator's gap on the same row
    t1 = time.perf_counter()
    eager = gens["eager"]
    no_ids = generator(False, pad_ids=None)
    faults = []
    for pi in (0, 1):
        ids, f = prompts[pi]
        ref_row = v1_logits_fn(eager, ids, f)(np.zeros(0, np.int64))[0]
        noise = row_gap(prefill_row(eager, ids, f), ref_row)
        gap_a = row_gap(prefill_row(no_ids, ids, f), ref_row)
        gap_b = row_gap(prefill_row(eager, ids, bad_feats), ref_row)
        faults.append((noise, gap_a, gap_b))
        if not gap_a > noise + tie:
            bad.append(f"prompt {pi}: first decode row against the "
                       f"recompute, {noise:.3g} ulps; fault (a) {gap_a:.3g} "
                       f"(must exceed {noise + tie:.3g})")
    # and their tokens, through the same gate as the true runs
    r_a = no_ids.generate(ids0, f0, max_new)
    r_b = eager.generate(ids0, bad_feats, max_new)
    chk_a = check(eager, ids0, f0, r_a.tokens)
    chk_b = check(eager, ids0, f0, r_b.tokens)
    del no_ids
    out["faults"] = {"rows": faults, "tokens_a": len(chk_a["bad"]),
                     "tokens_b": len(chk_b["bad"])}
    out["fault_s"] = time.perf_counter() - t1
    log(f"[qwen_v1] planted faults, first decode row's logits against the "
        f"v1 recompute (max |diff| in bf16 ulps of its top; prompt: true, "
        f"(a) no inline_pad_ids, judged here, (b) keys without positions, "
        f"judged by the tower's replica above): "
        + "; ".join(f"{pi}: {n:.3g}, {a:.3g}, {b:.3g}"
                    for pi, (n, a, b) in enumerate(faults))
        + f"; the token gate on prompt 0 rejects {len(chk_a['bad'])} (a) and "
        f"{len(chk_b['bad'])} (b) of {max_new} tokens; "
        f"{'rejected' if not bad else 'NOT rejected'} on {card}")
    if bad:
        raise AssertionError(f"[qwen_v1] planted faults pass: {bad}")

    per_token = 1e3 / max(1, sum(len(r.tokens) for r in runs["ar"]))
    per_step = 1e3 / max(1, sum(r.accept_steps for r in runs["msd"]))
    out.update(ar_ms=sum(secs["ar"]) * per_token,
               msd_ms_step=sum(secs["msd"]) * per_step,
               eager_ms_step=sum(secs["eager"]) * 1e3 / max(1, sum(
                   r.accept_steps for r in runs["eager"])),
               alpha=np.mean([r.avg_accept_len for r in runs["msd"]]))
    if on_card:
        out["ar_replay_ms"] = _replay_ms(gen, runs["ar"][0].graph)
        out["step_replay_ms"] = _replay_ms(gen, runs["msd"][0].graph)
        # K1 at this phase's AR row: the image prompts' mid-request kv_len
        kv_len = len(ids0) + max_new // 2
        s_target = -128 * (-(max_seq + tree.num_nodes) // 128)
        out["k1_row"] = time_k1_row(card, "Qwen-VL v1 AR row",
                                    lc.num_attention_heads,
                                    lc.num_key_value_heads, kv_len,
                                    s_target, layers)
    else:
        out["ar_replay_ms"] = out["step_replay_ms"] = float("nan")
    log(f"[qwen_v1] AR {out['ar_ms']:.2f} ms/token wall incl. prefill, "
        f"{out['ar_replay_ms']:.3f} ms per replayed AR token; MSD "
        f"{out['msd_ms_step']:.2f} ms/step graph, {out['eager_ms_step']:.2f}"
        f" eager (wall incl. prefill), {out['step_replay_ms']:.3f} ms per "
        f"replayed step, alpha {out['alpha']:.3f} on {card}")

    # the checkpoint in the public names: written, read back bitwise
    ckpt, ddir = f"{root}/qwen_vl_v1", f"{root}/draft_v1"
    t1 = time.perf_counter()
    written = save_qwen_vl_v1(tp, vision, qcfg, vcfg, ckpt, dtype)
    written += os.path.getsize(W.save_draft(drafts["msd"], ddir))
    out["write_s"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    lm2, vis2, qcfg2, vcfg2 = W.load_qwen_vl_v1(ckpt, dtype, device)
    dr2, _ = W.load_draft(ddir, qcfg2.as_llama(),
                          base_embed=lm2["embed_tokens"], dtype=dtype,
                          device=device)
    sync()
    out["load_s"] = time.perf_counter() - t1
    diff = _bitwise_diff("target", lm2, tp) \
        + _bitwise_diff("tower", vis2, vision) \
        + _bitwise_diff("draft", dr2, drafts["msd"])
    if diff or (qcfg2, vcfg2) != (qcfg, vcfg):
        raise AssertionError(f"[qwen_v1] the checkpoint does not load back "
                             f"bitwise: {diff[:8]}")
    del lm2, vis2, dr2
    log(f"[qwen_v1] checkpoint (the public Qwen/Qwen-VL names, bf16 "
        f"safetensors) + draft (save_draft): {written / 1e9:.3f} GB written "
        f"in {out['write_s']:.1f}s, loaded back bitwise by load_qwen_vl_v1 "
        f"in {out['load_s']:.1f}s on {card}")

    # the harness: B (the adapter's default, AR), A (--use_msd)
    gen_tasks = [t for t in tasks if t != "ai2d_ppl"]
    run = [None]
    reqs, scores, ar_steps = [], [], [0]
    orig = {"generate": MSDGenerator.generate,
            "naive_generate": MSDGenerator.naive_generate,
            "score": MSDGenerator.score, "ar_decode": SE.ar_decode}

    def wrap_gen(kind):
        def wrapped(self, ids, img_feats=None, max_new_tokens=None, **kw):
            before = captures(self)
            t1 = time.perf_counter()
            r = orig[kind](self, ids, img_feats, max_new_tokens, **kw)
            sync()
            mine = [q for q in reqs if q["run"] == run[0]]
            rec = {"run": run[0], "task": gen_tasks[len(mine) // limit],
                   "t": (t1, time.perf_counter()), "n": len(r.tokens),
                   "tokens": r.tokens.tolist(),
                   "captured": captures(self) - before,
                   "key": (kind, max_new_tokens, kw.get("sp"))}
            if run[0] == "A":
                rec["check"] = check(self, ids, img_feats, r.tokens,
                                     pad_ids=self.inline_pad_ids)
            else:
                a = [q for q in reqs if q["run"] == "A"][len(mine)]
                rec["split"] = check(self, ids, img_feats, a["tokens"],
                                     r.tokens,
                                     pad_ids=self.inline_pad_ids)["split"]
            reqs.append(rec)
            return r
        return wrapped

    def score(self, ids, cont_start, img_feats=None, img_grid=None):
        got = orig["score"](self, ids, cont_start, img_feats, img_grid)
        sync()
        rec = {"run": run[0], "out": got}
        if run[0] == "A":
            rec["plain"] = v1_plain_score(self, ids, cont_start, img_feats,
                                          self.inline_pad_ids)
        scores.append(rec)
        return got

    def ar_decode(*a, **kw):
        n = orig["ar_decode"](*a, **kw)
        ar_steps[0] += n - 1
        return n

    common = ["--model", "qwen_vl_eagle", "--model_args",
              f"pretrained={ckpt},max_seq_len={max_seq}",
              "--msd_model_path", ddir, "--device", str(device),
              "--limit", str(limit), "--tasks", ",".join(tasks),
              "--gen_kwargs", f"max_new_tokens={harness_new}",
              "--log_samples"]
    hruns = {"A": ["--use_msd"], "B": []}
    MSDGenerator.generate = wrap_gen("generate")
    MSDGenerator.naive_generate = wrap_gen("naive_generate")
    MSDGenerator.score = score
    SE.ar_decode = ar_decode
    try:
        for name, argv in hruns.items():
            run[0] = name
            steps0 = ar_steps[0]
            K1.decode_attention.launches = 0
            t1 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                payload = HM.main(argv + common)
            sync()
            out[name] = {"payload": payload, "s": time.perf_counter() - t1,
                         "launches": K1.decode_attention.launches,
                         "ar_steps": ar_steps[0] - steps0}
            gc.collect()
            if on_card:
                torch.cuda.empty_cache()
    finally:
        MSDGenerator.generate = orig["generate"]
        MSDGenerator.naive_generate = orig["naive_generate"]
        MSDGenerator.score = orig["score"]
        SE.ar_decode = orig["ar_decode"]

    def of(name):
        return [r for r in reqs if r["run"] == name]

    def responses(name, task):
        return [s["response"] for s in
                out[name]["payload"]["details"][task]["samples"]]

    bad = [f"{n} ran {len(of(n))} generate requests" for n in hruns
           if len(of(n)) != limit * len(gen_tasks)]
    if out["B"]["payload"]["msd_stats"]["accept_steps"] or \
            not out["A"]["payload"]["msd_stats"]["accept_steps"]:
        bad.append(f"B (the default) is not AR or A not MSD: "
                   f"{out['B']['payload']['msd_stats']}, "
                   f"{out['A']['payload']['msd_stats']}")
    hbad = [(r["task"], r["check"]["bad"]) for r in of("A")
            if r["check"]["bad"]]
    if hbad:
        bad.append(f"A's tokens off the v1 recompute: {hbad}")
    hsplits = [r["split"] for r in of("B") if r["split"] is not None]
    if not all(split_ok(sp, tie) for sp in hsplits):
        bad.append(f"B departs from A at a split that is no rounding tie: "
                   f"{hsplits}")
    if "ai2d_ppl" in tasks and responses("B", "ai2d_ppl") != \
            responses("A", "ai2d_ppl"):
        bad.append("B's loglikelihoods != A's (bitwise)")
    a_scores = [r for r in scores if r["run"] == "A"]
    worst = max((abs(r["out"][0] - r["plain"][0])
                 / max(1.0, abs(r["plain"][0])) for r in a_scores),
                default=0.0)
    if worst > 1e-4 or any(r["out"][1] != r["plain"][1] for r in a_scores):
        bad.append(f"score != its v1 recompute (worst relative "
                   f"{worst:.3e} against 1e-4, or a greedy flag)")
    b_caps = sum(r["captured"] for r in of("B"))
    hk1_want = layers * (out["B"]["ar_steps"] + WARMUP_STEPS * b_caps) \
        if on_card else 0
    if out["B"]["launches"] != hk1_want or out["A"]["launches"]:
        bad.append(f"K1 launches A {out['A']['launches']}, B "
                   f"{out['B']['launches']} (want {hk1_want})")

    def ms_per_token(name):
        rs = of(name)
        return 1e3 * sum(r["t"][1] - r["t"][0] for r in rs) \
            / max(1, sum(r["n"] for r in rs))

    out.update(harness_launches=out["B"]["launches"],
               harness_ar_steps=out["B"]["ar_steps"], harness_caps=b_caps,
               worst_score_rel=worst, harness_splits=hsplits,
               ms_token={n: ms_per_token(n) for n in hruns},
               peak=torch.cuda.max_memory_allocated() if on_card else 0,
               seconds=time.perf_counter() - t_phase)
    log(f"[qwen_v1] harness (--model qwen_vl_eagle, {limit} synthetic docs "
        f"of {', '.join(tasks)}, {harness_new} new tokens): B (the default, "
        f"AR) {out['B']['s']:.1f}s, A (--use_msd) {out['A']['s']:.1f}s; A's "
        f"tokens off the v1 recompute's canonical argmax: "
        f"{sum(r['check']['off'] for r in of('A'))} (allowed {tie:g} ulps + "
        f"the row's noise), off the shaped recompute's: "
        f"{sum(r['check']['off_b'] for r in of('A'))}; B == A up to each "
        f"first split ("
        + ("; ".join(f"token {s['at']}, {s['ulps']:.1f} ulps (noise "
                     f"{s['noise']:g})" for s in hsplits) or "no split")
        + f"); ai2d_ppl A == B bitwise, recompute worst relative "
        f"{worst:.3e}; ms per generated token (prefill included) A "
        f"{out['ms_token']['A']:.2f}, B {out['ms_token']['B']:.2f}; K1 in B "
        f"{out['B']['launches']} = {layers} x ({out['B']['ar_steps']} AR "
        f"tokens decoded + {WARMUP_STEPS} warm-up steps x {b_caps} "
        f"capture), 0 in A on {card}")
    if bad:
        raise AssertionError(f"[qwen_v1] {bad}")
    log(f"[qwen_v1] peak {out['peak'] / 2**30:.2f} GiB allocated; phase "
        f"{out['seconds']:.1f}s, of which the recompute checks "
        f"{check_s[0]:.1f}s and the planted faults {out['fault_s']:.1f}s on "
        f"{card}")
    del gens, gen, eager
    return out


def timed_calls(module, names):
    """Patch ``module``'s functions ``names`` to record each call's host
    seconds, the device synchronised on both sides (for prefills, which
    no graph holds). Returns (seconds lists by name, restore)."""
    import torch

    on_card = torch.cuda.is_available()
    orig = {n: getattr(module, n) for n in names}
    secs = {n: [] for n in names}

    def wrap(n):
        def timed(*a, **kw):
            if on_card:
                torch.cuda.synchronize()
            t1 = time.perf_counter()
            r = orig[n](*a, **kw)
            if on_card:
                torch.cuda.synchronize()
            secs[n].append(time.perf_counter() - t1)
            return r
        return timed

    for n in names:
        setattr(module, n, wrap(n))

    def restore():
        for n, f in orig.items():
            setattr(module, n, f)
    return secs, restore


def _prep_ms(fn, img, reps: int = 5) -> float:
    """Host ms per call of an image prep ``fn(img)`` (a first call
    untimed: the native library builds there)."""
    fn(img)
    t1 = time.perf_counter()
    for _ in range(reps):
        fn(img)
    return (time.perf_counter() - t1) * 1e3 / reps


def run_multi(res, serve, max_seq: int = MULTI_SEQ, max_new: int = MULTI_NEW,
              pad_multiple: int = 64, max_new_warm: int = 4) -> dict:
    """Multi-visual LLaVA prompts on the main path's target, medusa and
    null drafts and ``[serve]``'s CLIP tower and projector, on generators
    of their own (``max_seq`` cache, ``pad_multiple`` prompt buckets) that
    share those tensors and are released at the end. Seeded uint8 images
    through the native prep, four requests of 64 text tokens x
    ``max_new`` new tokens:

    (a) two base-size images at two placeholders (2 x 576 rows at 336px);
    (b) one 3 x 2 base image (1008 x 672 at 336) through anyres
        (``process_anyres_image``: a 2 x 2 grid plus the base view,
        ``merge_anyres_features`` 'spatial_unpad' with a seeded
        ``image_newline``: 576 + 32 x 49 = 2144 rows at 336);
    (c) one image through S2 at (1, 2, 3) x base with a seeded projector
        from 3 x the tower's width;
    (d) one image as a one-block list (the prefused prefill, padded from
        e0) and as a tensor (the standard path, padded, then expanded).

    Each list request runs graph MSD, eager MSD, graph null-draft MSD and
    the AR baseline (``naive_generate``, K1). Fails unless MSD == eager ==
    null draft, bitwise; every committed MSD token passes ``token_check``
    against the image rows spliced in by concatenation (exact at the
    verify's row shapes, within ``HARNESS_TIE`` bf16 ulps plus the row's
    noise unpadded; exact off the card); AR equals MSD up to the first
    split, each split such a tie (none off the card); (d)'s two paths
    likewise; K1 launches layers x AR tokens decoded, 0 in MSD; no
    capture in a timed run; and the gate rejects MSD over a planted
    ``fuse_embeddings_multi`` that gives (a)'s second placeholder the
    first image's block.
    Prints the prefill ms, the replayed ms per step, the towers' ms and
    the native against the PIL prep ms per image."""
    import torch
    from msd_tpu_torch.configs import IMAGE_TOKEN_INDEX, EngineConfig
    from msd_tpu_torch.engine import spec_engine as SE
    from msd_tpu_torch.engine.generator import MSDGenerator
    from msd_tpu_torch.models import llava as LV
    from msd_tpu_torch.ops import decode_attention as K1
    from msd_tpu_torch.utils import mm_utils as MM

    ctx = res["ctx"]
    main, drafts, tcfg = ctx["gens"]["graph"], ctx["drafts"], ctx["tcfg"]
    sync, on_card, device = ctx["sync"], ctx["on_card"], ctx["device"]
    lp, lcfg = serve["llava"], serve["lcfg"]
    vcfg = lcfg.vision
    base = vcfg.image_size
    card = smi_name_and_limit() if on_card else "cpu"
    tie = HARNESS_TIE if on_card else 0.0
    t_phase = time.perf_counter()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    eng = EngineConfig(max_seq_len=max_seq, prompt_pad_multiple=pad_multiple,
                       tree=main.eng.tree)

    def generator(cuda_graphs):
        return MSDGenerator(main.params["target"], drafts["msd"], tcfg,
                            main.dcfg, eng, n_img=main.n_img, eos_id=-1,
                            sp=main.sp, device=device,
                            cuda_graphs=cuda_graphs)

    gens = {"graph": generator(True), "eager": generator(False)}
    out = {"card": card}

    # seeded images; the native prep against the PIL path
    rng = np.random.default_rng(21)
    g = torch.Generator(device=device).manual_seed(21)
    # (a)'s two images: seeded noise and a seeded smooth gradient, so
    # their rows differ in content as well as in place
    ramp = np.linspace(0.0, 1.0, base)
    imgs = [rng.integers(0, 256, size=(base, base, 3), dtype=np.uint8),
            (255 * np.stack([np.outer(ramp, ramp), ramp[None].repeat(base, 0),
                             ramp[:, None].repeat(base, 1)], -1)
             * rng.uniform(0.5, 1.0, 3)).astype(np.uint8)]
    aw, ah = 3 * base, 2 * base
    wide = rng.integers(0, 256, size=(ah, aw, 3), dtype=np.uint8)
    scales = (base, 2 * base, 3 * base)
    big = rng.integers(0, 256, size=(scales[-1],) * 2 + (3,), dtype=np.uint8)
    pins = tuple((w * base // 336, h * base // 336)
                 for w, h in MM.DEFAULT_GRID_PINPOINTS)
    out["prep_ms"] = {
        "native": _prep_ms(lambda im: MM.process_image(im, base), imgs[0]),
        "pil": _prep_ms(lambda im: MM.process_image(im, base,
                                                    use_native=False),
                        imgs[0]),
        "native_s2": _prep_ms(lambda im: MM.process_image(im, scales[-1]),
                              big, 2),
        "pil_s2": _prep_ms(lambda im: MM.process_image(
            im, scales[-1], use_native=False), big, 2),
        "anyres": _prep_ms(lambda im: MM.process_anyres_image(im, base,
                                                              pins), wide, 2)}

    def encode(cfg, params, px, label):
        x = torch.from_numpy(px).to(device)
        LV.encode_image(params, cfg, x)            # warm-up
        sync()
        t1 = time.perf_counter()
        f = LV.encode_image(params, cfg, x)
        sync()
        out.setdefault("tower_ms", {})[label] = \
            (time.perf_counter() - t1) * 1e3
        return f

    fa = [encode(lcfg, lp, MM.process_image(im, base), "image")
          for im in imgs[:2]]
    views = MM.process_anyres_image(wide, base, pins)
    grid_wh = MM.get_anyres_image_grid_shape((aw, ah), pins, base)
    tiles = encode(lcfg, lp, views, "anyres views")
    newline = torch.randn(tcfg.hidden_size, generator=g, device=device,
                          dtype=tiles.dtype).mul_(0.02)
    fb = LV.merge_anyres_features(tiles, grid_wh, (aw, ah),
                                  base // vcfg.patch_size,
                                  image_newline=newline,
                                  mode="spatial_unpad")
    s2cfg = dataclasses.replace(lcfg, s2_scales=scales)
    s2 = {"vision": lp["vision"],
          "projector": LV.init_projector_params(s2cfg, g, device,
                                                fa[0].dtype)}
    fc = encode(s2cfg, s2, MM.process_image(big, scales[-1]), "S2")
    bad = [f"{k}: rows {tuple(f.shape)}, finite "
           f"{bool(torch.isfinite(f).all())}"
           for k, f in (("a0", fa[0]), ("a1", fa[1]), ("b", fb), ("c", fc))
           if f.shape[-1] != tcfg.hidden_size
           or not bool(torch.isfinite(f).all())]
    if bad:
        raise AssertionError(f"[multi] visual rows: {bad}")
    log(f"[multi] prep per image: native {out['prep_ms']['native']:.2f} ms,"
        f" PIL {out['prep_ms']['pil']:.2f} ms at {base}px; at "
        f"{scales[-1]}px native {out['prep_ms']['native_s2']:.2f} ms, PIL "
        f"{out['prep_ms']['pil_s2']:.2f} ms; anyres {aw}x{ah} (1 + "
        f"{len(views) - 1} views) {out['prep_ms']['anyres']:.2f} ms. Towers:"
        f" " + ", ".join(f"{k} {v:.2f} ms" for k, v in
                          out["tower_ms"].items())
        + f"; anyres grid {grid_wh}, {fb.shape[0]} merged rows; S2 "
        f"{scales}: {fc.shape[0]} rows from {sum((s // base) ** 2 for s in scales)}"
        f" tiles, projector {s2cfg.mm_hidden_size} -> {tcfg.hidden_size} on "
        f"{card}")

    vocab_hi = min(31000, tcfg.vocab_size - 1)

    def prompt(*spots):
        ids = rng.integers(3, vocab_hi, size=64).astype(np.int32)
        ids[list(spots)] = IMAGE_TOKEN_INDEX
        return ids

    reqs = {"a": (prompt(1, 33), fa), "b": (prompt(1), [fb]),
            "c": (prompt(1), [fc]), "d": (prompt(1), [fa[0]])}

    def captures(gen):
        return 0 if gen.graphs is None else len(gen.graphs.steps)

    gen, eager = gens["graph"], gens["eager"]
    ids_a, blocks_a = reqs["a"]
    gen.naive_generate(ids_a, blocks_a, max_new_warm)
    for name in ("null", "msd"):
        gen.params["draft"] = drafts[name]
        gen.generate(ids_a, blocks_a, max_new_warm)
    eager.generate(ids_a, blocks_a, max_new_warm)
    sync()
    n_cap = captures(gen)
    secs, restore = timed_calls(SE, ("prefill", "prefill_prefused",
                                     "ar_prefill_prefused"))
    runs, wall, launches = {}, {}, {}
    try:
        for key, (ids, blocks) in reqs.items():
            for name in ("ar", "msd", "null", "eager"):
                g_ = eager if name == "eager" else gen
                g_.params["draft"] = drafts["null" if name == "null"
                                            else "msd"]
                # the counts of this path: zeroed just before, read after
                K1.decode_attention.launches = 0
                t1 = time.perf_counter()
                r = g_.naive_generate(ids, blocks, max_new) if name == "ar" \
                    else g_.generate(ids, blocks, max_new)
                sync()
                wall[key, name] = time.perf_counter() - t1
                launches[key, name] = K1.decode_attention.launches
                runs[key, name] = r
                if g_.graphs is not None and not g_.graphs.reads(r.graph,
                                                                 g_.params):
                    raise AssertionError(f"[multi] {key} {name}: replayed a "
                                         f"graph captured for other weights")
        gen.params["draft"] = drafts["msd"]
        ids_d, blocks_d = reqs["d"]
        t1 = time.perf_counter()
        runs["d", "standard"] = gen.generate(ids_d, blocks_d[0], max_new)
        sync()
        wall["d", "standard"] = time.perf_counter() - t1
    finally:
        restore()
    if captures(gen) != n_cap or captures(eager):
        raise AssertionError("[multi] a capture inside the timed runs")
    layers = tcfg.num_hidden_layers
    ar_decoded = sum(len(runs[k, "ar"].tokens) - 1 for k in reqs)
    k1_ar = sum(launches[k, "ar"] for k in reqs)
    k1_msd = sum(launches[k, n] for k in reqs
                 for n in ("msd", "null", "eager"))
    out.update(launches=k1_ar, ar_decoded=ar_decoded,
               launches_by={k: launches[k, "ar"] for k in reqs})
    bad = []
    if k1_ar != (layers * ar_decoded if on_card else 0) or k1_msd:
        bad.append(f"K1 launches {k1_ar} in AR (want {layers} x "
                   f"{ar_decoded} AR tokens decoded), {k1_msd} in MSD")
    checks, t_chk, same = {}, time.perf_counter(), True
    for key, (ids, blocks) in reqs.items():
        toks = {n: runs[key, n].tokens for n in ("ar", "msd", "null",
                                                 "eager")}
        for n, t in toks.items():
            if t.shape != (max_new,) or t.min() < 0 \
                    or t.max() >= tcfg.vocab_size:
                bad.append(f"{key} {n}: bad tokens {t.shape}")
        if not (np.array_equal(toks["msd"], toks["null"])
                and np.array_equal(toks["msd"], toks["eager"])):
            same = False
            bad.append(f"{key}: MSD, eager MSD and null-draft tokens differ")
        chk = token_check(gen, llava_logits_fn(gen, ids, blocks),
                          toks["msd"], toks["ar"], tie)
        checks[key] = chk
        if chk["bad"]:
            bad.append(f"{key}: committed tokens off the recompute's argmax "
                       f"(token, ulps below A's top, allowed, below B's, "
                       f"rank): {chk['bad']}")
        if not split_ok(chk["split"], tie):
            bad.append(f"{key}: AR departs from MSD at a split that is no "
                       f"rounding tie: {chk['split']}")
    ids_d, blocks_d = reqs["d"]
    std = runs["d", "standard"].tokens
    checks["d std"] = token_check(gen, llava_logits_fn(gen, ids_d, blocks_d),
                                  runs["d", "msd"].tokens, std, tie)
    if not split_ok(checks["d std"]["split"], tie):
        bad.append(f"d: the standard path departs from the prefused one at "
                   f"a split that is no rounding tie: "
                   f"{checks['d std']['split']}")
    out["check_s"] = time.perf_counter() - t_chk
    m = gen.eng.prompt_pad_multiple
    e0 = {k: len(ids) - len(bl) + sum(len(b) for b in bl)
          for k, (ids, bl) in reqs.items()}
    rows_std = -m * (-len(ids_d) // m) + gen.n_img - 1
    rows_pre = -m * (-e0["d"] // m)
    splits = {k: c["split"] for k, c in checks.items()
              if c["split"] is not None}
    log(f"[multi] {len(reqs)} requests x {max_new} tokens, expanded prompt "
        f"rows {e0}: graph MSD == eager MSD == null draft: {same}; "
        f"committed MSD tokens off "
        f"the recompute's canonical argmax "
        f"{sum(c['off'] for k, c in checks.items() if k != 'd std')} of "
        f"{len(reqs) * max_new} (off the shaped recompute's "
        f"{sum(c['off_b'] for k, c in checks.items() if k != 'd std')}, "
        f"allowed 0), noise up to "
        f"{max(c['noise'] for c in checks.values()):.2f} ulps; AR == MSD up "
        f"to the first split, splits (request: token, ulps, noise, ranks): "
        + ("; ".join(f"{k}: {s['at']}, {s['ulps']:.1f}, {s['noise']:g}, "
                     f"{s['ranks']}" for k, s in splits.items()) or "none")
        + f"; (d) prefill rows: standard {rows_std} ({m}-multiple padding "
        f"then expansion), prefused {rows_pre} (padding of e0 "
        f"{e0['d']}); K1 launches {k1_ar} = {layers} x {ar_decoded} AR "
        f"tokens decoded, {k1_msd} in MSD on {card}")
    if bad:
        raise AssertionError(f"[multi] {bad}")

    # the planted fault: every placeholder of (a) takes the first
    # image's block in the fusion (a swap of the two blocks keeps every
    # row and moves them by 33 positions, which random weights do not
    # tell apart: no gate rejected it on an H100)
    real = LV.fuse_embeddings_multi

    def first_block(table, ids, feats_list):
        return real(table, ids, [feats_list[0]] * len(feats_list))

    LV.fuse_embeddings_multi = first_block
    try:
        faulty = gen.generate(ids_a, blocks_a, max_new)
    finally:
        LV.fuse_embeddings_multi = real
    chk = token_check(gen, llava_logits_fn(gen, ids_a, blocks_a),
                      faulty.tokens, tie=tie)
    differ = np.flatnonzero(faulty.tokens != runs["a", "msd"].tokens)
    if not (chk["bad_a"] and chk["off_b"]):
        raise AssertionError(f"[multi] MSD over the first image's block "
                             f"at both placeholders passes the recompute "
                             f"gate: A rejects "
                             f"{chk['bad_a']} tokens, B {chk['off_b']}")
    out["fault"] = {"by_a": chk["bad_a"], "by_b": chk["off_b"],
                    "differ": int(differ[0]) if len(differ) else None}
    log(f"[multi] planted fault (fuse_embeddings_multi giving (a)'s "
        f"second placeholder the first image's block): tokens first differ "
        f"at "
        f"{out['fault']['differ']}; the gate rejects {chk['bad_a']} of "
        f"{max_new} by A's allowance and {chk['off_b']} off B's argmax, so "
        f"[multi] fails it, as it must, on {card}")

    def ms(key, name, unit):
        r = runs[key, name]
        n = len(r.tokens) if unit == "token" else max(r.accept_steps, 1)
        return wall[key, name] * 1e3 / n

    # per request: the MSD, null and eager prefills, then the standard one
    out["prefill_ms"] = {k: v * 1e3 for k, v in zip(
        list(reqs) + ["d standard"],
        secs["prefill_prefused"][::3] + secs["prefill"])}
    out["ar_prefill_ms"] = {k: v * 1e3 for k, v in zip(
        reqs, secs["ar_prefill_prefused"])}
    out["msd_ms_step"] = {k: ms(k, "msd", "step") for k in reqs}
    out["eager_ms_step"] = {k: ms(k, "eager", "step") for k in reqs}
    out["ar_ms"] = {k: ms(k, "ar", "token") for k in reqs}
    if on_card:
        out["step_replay_ms"] = _replay_ms(gen, runs["a", "msd"].graph)
        out["ar_replay_ms"] = _replay_ms(gen, runs["a", "ar"].graph)
    else:
        out["step_replay_ms"] = out["ar_replay_ms"] = float("nan")
    out["peak"] = torch.cuda.max_memory_allocated() if on_card else 0
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[multi] prefill ms (MSD): " + ", ".join(
        f"{k} {v:.2f}" for k, v in out["prefill_ms"].items())
        + "; AR prefill ms: " + ", ".join(
            f"{k} {v:.2f}" for k, v in out["ar_prefill_ms"].items())
        + f"; replayed verify step {out['step_replay_ms']:.3f} ms, AR token "
        f"{out['ar_replay_ms']:.3f} ms (request a); wall ms/step graph "
        + ", ".join(f"{k} {v:.2f}" for k, v in out["msd_ms_step"].items())
        + "; eager " + ", ".join(f"{k} {v:.2f}" for k, v in
                                 out["eager_ms_step"].items())
        + "; AR ms/token " + ", ".join(f"{k} {v:.2f}" for k, v in
                                       out["ar_ms"].items())
        + f"; recompute checks {out['check_s']:.1f}s; peak "
        f"{out['peak'] / 2**30:.2f} GiB; phase {out['seconds']:.1f}s on "
        f"{card}")
    # the phase's generators, states and graphs go
    del gens, gen, eager
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    return out


def seeded_checkpoint(path: str, lcfg, seed: int = 14, device="cuda",
                      dtype=None) -> int:
    """Write an HF-layout LLaVA checkpoint (``save_llava``) of target,
    tower and projector weights drawn from a seeded ``torch.Generator`` on
    ``device`` (bf16 on the card, fp32 elsewhere); returns the bytes. For
    running ``[train]`` without the phases before it (the tiny CPU test,
    a card run of the phase alone)."""
    import torch
    from msd_tpu_torch.models import clip_vit as CV
    from msd_tpu_torch.models import llama as L
    from msd_tpu_torch.models import llava as LV
    from msd_tpu_torch.utils import weights as W

    if dtype is None:
        dtype = torch.bfloat16 if str(device).startswith("cuda") \
            else torch.float32
    g = torch.Generator(device=device).manual_seed(seed)
    params = {"target": L.init_llama_params(lcfg.text, g, device, dtype),
              "vision": CV.init_clip_params(lcfg.vision, g, device, dtype),
              "projector": LV.init_projector_params(lcfg, g, device, dtype)}
    params["target"]["lm_head"].mul_(HEAD_SHARPEN)
    return W.save_llava(params, lcfg, path, dtype)


def train_conversations(rng, n: int, image: bool) -> list:
    """``n`` LLaVA-instruct samples of two seeded two-turn conversations
    (the first human turn tagged ``<image>\\n`` when ``image``)."""
    words = ("red", "blue", "square", "circle", "left", "right", "top",
             "small", "large", "two", "three", "chart", "line", "bar")

    def phrase(k):
        return " ".join(words[i] for i in rng.integers(0, len(words), k))

    out = []
    for i in range(n):
        q1 = f"what is shown {i}? {phrase(3)}"
        out.append({"conversations": [
            {"from": "human", "value": ("<image>\n" if image else "") + q1},
            {"from": "gpt", "value": f"a {phrase(4)} {i}"},
            {"from": "human", "value": f"and then {phrase(2)}?"},
            {"from": "gpt", "value": phrase(3)}]})
    return out


def record_fields_check(rec: dict, rows: int, hidden: int) -> list:
    """What differs from the keys, shapes and dtypes of the JAX package's
    training record of ``rows`` rows (``train/data_gen``)."""
    want = {"emb_next": ((rows, hidden), np.float32),
            "hidden": ((rows, hidden), np.float32),
            "target": ((rows, hidden), np.float32),
            "loss_mask": ((rows,), np.float32), "attn_len": ((), np.int32),
            "img_mask": ((rows,), np.bool_), "exp_ids": ((rows,), np.int32)}
    bad = [k for k in set(want) | set(rec) if k not in rec or k not in want
           or rec[k].shape != want[k][0] or rec[k].dtype != want[k][1]]
    return [f"keys, shapes or dtypes of {sorted(bad)}"] if bad else []


def record_layout_check(rec: dict, tokenizer, turns, image: bool,
                        pad_to: int, n_img: int, hidden: int) -> list:
    """What differs from the JAX package's record layout: the keys,
    shapes and dtypes, the image rows of ``img_mask`` (row j where token
    j+1 is an image row), ``attn_len`` (the expanded length of the
    conversation cut to ``pad_to``) and a non-zero ``loss_mask`` that is 0
    on the image rows. The expected positions come from
    ``build_conversation_ids``."""
    from msd_tpu_torch.configs import IMAGE_TOKEN_INDEX
    from msd_tpu_torch.train.data_gen import build_conversation_ids

    ids, _ = build_conversation_ids(tokenizer, turns, image)
    ids = ids[:pad_to]
    rows = pad_to + (n_img - 1 if image else 0)
    bad = record_fields_check(rec, rows, hidden)
    if bad:
        return bad
    j = np.arange(rows)
    if image:
        p = int(np.argmax(ids == IMAGE_TOKEN_INDEX))
        img = (j + 1 >= p) & (j + 1 < p + n_img)
    else:
        img = np.zeros(rows, bool)
    e_len = len(ids) + (n_img - 1 if image else 0)
    if not np.array_equal(rec["img_mask"], img):
        bad.append("img_mask rows")
    if int(rec["attn_len"]) != e_len:
        bad.append(f"attn_len {int(rec['attn_len'])} != {e_len}")
    if rec["loss_mask"].sum() == 0 or rec["loss_mask"][img].any():
        bad.append("loss_mask empty or set on image rows")
    return bad


def host_snapshot(tree) -> dict:
    """Host copies of the tensors of ``tree`` by ``_flat_tensors`` name,
    in page-locked memory when they lie on the card (a 7B LM's 13.5 GB
    move at the copy engine's rate, not the pageable path's)."""
    import torch
    out = {}
    for k, t in _flat_tensors(tree).items():
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=t.is_cuda)
        h.copy_(t.detach())
        out[k] = h
    return out


def frozen_lm_check(tp, snapshot: dict) -> list:
    """Names of the LM tensors that are not bitwise their host
    ``snapshot`` (each compared on its device, one at a time)."""
    import torch
    return [k for k, t in _flat_tensors(tp).items()
            if not torch.equal(t.detach(), snapshot[k].to(t.device))]


def finetune_recompute_loss(params, cfg, batch, n_img: int) -> float:
    """The masked mean next-token cross entropy of a finetune batch,
    recomputed eagerly apart from ``finetune_loss``: per sequence, the
    projector in fp32 over its CLIP features, the fused rows built by
    concatenation (text before the placeholder, the image rows, the text
    after, zero rows up to P_exp), ``llama_forward`` over a P_exp-row
    cache with the causal and length mask, ``lm_head`` and an fp32
    log-softmax, the label of row j the expanded token j+1."""
    import torch
    from msd_tpu_torch.models import llama as L
    from msd_tpu_torch.models.llava import projector_apply
    from msd_tpu_torch.ops.attention import NEG_INF

    tp = params["target"]
    emb = tp["embed_tokens"]
    dev = emb.device
    B, Tp = batch.ids.shape
    P = Tp + n_img - 1
    cos, sin = L.make_rope(cfg, P + 8, dev)
    total = torch.zeros((), dtype=torch.float64, device=dev)
    with torch.no_grad():
        for b in range(B):
            ids = batch.ids[b].long().clamp(min=0)
            n, p = int(batch.attn_len[b]), int(batch.img_pos[b])
            if p < n:
                proj = {k: v.float() for k, v in params["projector"].items()}
                feats = projector_apply(proj, batch.clip_feats[b].float())
                rows = torch.cat([emb[ids[:p]], feats.to(emb.dtype),
                                  emb[ids[p + 1:]]])
                labels = torch.cat([ids[:p], ids.new_zeros(n_img),
                                    ids[p + 1:]])
                e_len = n + n_img - 1
            else:
                rows = torch.cat([emb[ids], emb.new_zeros(P - Tp,
                                                          emb.shape[1])])
                labels = torch.cat([ids, ids.new_zeros(P - Tp)])
                e_len = n
            q = torch.arange(P, device=dev)
            keep = (q[None, :] <= q[:, None]) & (q[None, :] < e_len)
            bias = torch.where(keep, 0.0, NEG_INF).float()
            hidden, _ = L.llama_forward(
                tp, cfg, rows, q.int(), L.init_kv_cache(cfg, P, rows.dtype,
                                                        dev), 0, bias, cos,
                sin)
            logp = torch.log_softmax(L.lm_head(tp, hidden).float(), dim=-1)
            nll = -logp[q[:-1], labels[1:]]
            total += (nll.double() * batch.tgt_mask[b][:-1].double()).sum()
    return float(total / (batch.tgt_mask.sum().double() + 1e-5))


def run_train(ckpt: str, root: str, device="cuda", pad_to: int = 256,
              ft2_pad: int = 128, fit_epochs: int = 4, ft1_steps: int = 4,
              ft2_steps: int = 3, pipe_docs: int = 4, pipe_steps: int = 20,
              pipe_limit: int = 4, max_new: int = HARNESS_NEW,
              fit_max_len: int = 832, fit_lr: float = FIT_LR) -> dict:
    """The training entry point at the checkpoint ``ckpt``'s width (the
    LLaVA-1.5-7B checkpoint ``[weights]`` wrote, on the card), all through
    ``msd_tpu_torch.train``; scratch files under ``root``:

    1. ``gen-data`` (``train.__main__.main`` in process, ``--no-image``)
       over a synthetic LLaVA-instruct JSON of 8 two-turn conversations,
       and ``generate_dataset`` in process over 4 seeded images through
       the tower and projector, ``pad_to`` 256 (831 expanded rows at 576
       image rows): every record in the JAX package's layout.
    2. ``fit`` over both record directories (the text -> visual curriculum,
       ``fit_epochs`` epochs at batch 2: 19 steps at ``--lr`` ``fit_lr``
       under TrainConfig's 2000-step warmup), each step timed; epoch 1's mean
       loss below epoch 0's (the same 8 text records); the export
       (``load_draft``) bitwise the trainer's bf16 cast; served through
       ``set_draft`` on a generator over the target, it commits the
       null-draft tokens on the synthetic_vqa prompts (alpha before
       distillation). One more step profiled.
    3. ``LlavaFinetuner`` stage 1 (``tune_mm_mlp_adapter``): batch 2,
       ``pad_to`` 256, ``ft1_steps`` steps over the image records; the LM
       bitwise its host snapshot, the projector moved, the first step's
       loss within 1e-3 (relative) of ``finetune_recompute_loss``. The
       planted fault: a stage-1 finetuner whose optimizer also updates the
       LM (its ``set_to_zero`` dropped), two steps, must fail the same
       frozen-LM gate.
    4. Stage 2 (the full finetune): batch 1, ``ft2_pad`` 128 (703 rows),
       ``ft2_steps`` steps with ``warmup_steps=1``: update 0 (lr 0) leaves
       the LM bitwise, update 1 moves every layer-0 projection; rows of
       ``embed_tokens`` whose ids no batch holds stay bitwise; the loss
       finite. One more step profiled; peak memory.
    5. ``pipeline`` (``main`` in process) over the checkpoint and fit's
       export: synthetic_vqa, 4 docs distilled for 20 steps, 4 evaluated;
       the distilled draft, installed by ``set_draft``, commits the
       null-draft tokens on the same prompts (alpha after).

    K1 launches 0 times in the phase (no training row goes to it). Raises
    on any failed gate; returns the numbers."""
    import torch
    from msd_tpu_torch.configs import DraftConfig
    from msd_tpu_torch.engine.generator import MSDGenerator
    from msd_tpu_torch.harness.models.llava_msd import (LlavaMSD,
                                                         SimpleTokenizer,
                                                         checkpoint_engine)
    from msd_tpu_torch.harness.registry import TASK_REGISTRY, get_task
    from msd_tpu_torch.harness.tasks import register_builtin_tasks
    from msd_tpu_torch.models import draft as D
    from msd_tpu_torch.models.clip_vit import clip_encode
    from msd_tpu_torch.models.llava import encode_image
    from msd_tpu_torch.ops import decode_attention as K1
    from msd_tpu_torch.train import __main__ as TM
    from msd_tpu_torch.train import data_gen as TG
    from msd_tpu_torch.train import finetune as FT
    from msd_tpu_torch.train import trainer as TTR
    from msd_tpu_torch.train.draft_train import train_step
    from msd_tpu_torch.utils import weights as W
    from msd_tpu_torch.utils.mm_utils import process_image
    from msd_tpu_torch.utils.profiling import Timer

    on_card = str(device).startswith("cuda")
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    card = smi_name_and_limit() if on_card else "cpu"
    dtype = torch.bfloat16 if on_card else torch.float32
    t_phase = time.perf_counter()
    out = {"card": card}
    K1.decode_attention.launches = 0
    K1.decode_attention.captured = 0
    bad = []

    def peak_reset():
        if on_card:
            torch.cuda.reset_peak_memory_stats()

    def peak():
        return torch.cuda.max_memory_allocated() if on_card else 0

    # 1. records: text through the CLI, images in process
    rng = np.random.default_rng(14)
    text = train_conversations(rng, 8, image=False)
    vis = train_conversations(rng, 4, image=True)
    data = os.path.join(root, "instruct.json")
    with open(data, "w") as f:
        json.dump(text, f)
    dirs = {k: os.path.join(root, k) for k in ("text", "visual", "fit")}
    gd_s = []
    gen_dataset = TG.generate_dataset

    def timed_dataset(*a, **kw):
        sync()
        t1 = time.perf_counter()
        n = gen_dataset(*a, **kw)
        sync()
        gd_s.append((n, time.perf_counter() - t1))
        return n

    TG.generate_dataset = timed_dataset
    try:
        t1 = time.perf_counter()
        n_text = TM.main(["gen-data", "--basepath", ckpt, "--data", data,
                          "--outdir", dirs["text"], "--no-image",
                          "--pad-to", str(pad_to), "--device", str(device)])
        out["gen_data_cli_s"] = time.perf_counter() - t1
        gc.collect()
        t1 = time.perf_counter()
        params, lcfg = W.load_llava(ckpt, dtype, device)
        sync()
        out["load_s"] = time.perf_counter() - t1
        tcfg, n_img = lcfg.text, lcfg.num_image_tokens
        tok = SimpleTokenizer(vocab_size=tcfg.vocab_size)
        lp = {"vision": params["vision"], "projector": params["projector"]}
        images = [rng.integers(0, 256, size=(280 + 40 * i, 336, 3),
                               dtype=np.uint8) for i in range(len(vis))]
        samples = [{"turns": TM._turns(r), "image": im}
                   for r, im in zip(vis, images)]

        def enc(px):
            with torch.no_grad():
                return encode_image(lp, lcfg, px)

        n_vis = TG.generate_dataset(params["target"], tcfg, tok, samples,
                                    dirs["visual"], encode_image_fn=enc,
                                    n_img=n_img, pad_to=pad_to)
    finally:
        TG.generate_dataset = gen_dataset
    out["records_per_s"] = {"text (gen-data)": gd_s[0][0] / gd_s[0][1],
                            "image (generate_dataset)": gd_s[1][0]
                            / gd_s[1][1]}
    if (n_text, n_vis) != (len(text), len(vis)):
        bad.append(f"records written: {n_text} text, {n_vis} image")
    for kind, convs in (("text", text), ("visual", vis)):
        for i, r in enumerate(convs):
            rec = dict(np.load(os.path.join(dirs[kind], f"rec_{i:06d}.npz")))
            for b in record_layout_check(rec, tok, TM._turns(r),
                                         kind == "visual", pad_to, n_img,
                                         tcfg.hidden_size):
                bad.append(f"{kind} record {i}: {b}")
    if bad:
        raise AssertionError(f"[train] records: {bad}")
    log(f"[train] records: {n_text} text through gen-data (CLI call "
        f"{out['gen_data_cli_s']:.1f}s with its checkpoint load; the "
        f"phase's own load {out['load_s']:.1f}s; "
        f"{out['records_per_s']['text (gen-data)']:.1f} records/s in "
        f"generate_dataset), {n_vis} image records in process "
        f"({out['records_per_s']['image (generate_dataset)']:.1f} "
        f"records/s, tower and projector included) at pad_to {pad_to} "
        f"({pad_to + n_img - 1} expanded rows): the JAX layout (keys, "
        f"shapes, dtypes, image rows, attn_len, loss mask) on {card}")

    # 2. fit over both directories, every step timed
    steps = []

    def timed_step(*a, **kw):
        with Timer("fit step") as tm:
            m = train_step(*a, **kw)
            loss = float(m["loss"])
        steps.append((loss, tm.elapsed))
        return m

    peak_reset()
    TTR.train_step = timed_step
    try:
        t1 = time.perf_counter()
        trainer = TM.main(["fit", "--basepath", ckpt, "--tmpdir_v",
                           dirs["visual"], "--tmpdir_t", dirs["text"],
                           "--cpdir", dirs["fit"], "--epochs",
                           str(fit_epochs), "--bs", "2", "--max-len",
                           str(fit_max_len), "--lr", str(fit_lr),
                           "--device", str(device)])
        out["fit_s"] = time.perf_counter() - t1
    finally:
        TTR.train_step = train_step
    out["fit_peak"] = peak()
    losses = [s[0] for s in steps]
    out["fit_steps"] = len(steps)
    out["fit_ms"] = 1e3 * float(np.mean([s[1] for s in steps[1:]]))
    # like for like: epochs 0 and 1 each take the same text records (the
    # curriculum adds the visual records, whose loss runs higher, from
    # the middle epoch on, so the last steps and the first see other data)
    per = len(text) // 2
    first = float(np.mean(losses[:per]))
    second = float(np.mean(losses[per:2 * per]))
    out["fit_loss"] = (first, second)
    out["fit_losses"] = losses
    if not (fit_epochs >= 4 and second < first
            and np.isfinite(losses).all()):
        bad.append(f"fit: mean loss of epoch 1 {second:.4f} not below "
                   f"epoch 0's {first:.4f} over the same {len(text)} text "
                   f"records; step losses {losses}")
    dcfg = DraftConfig(text=tcfg)
    export = os.path.join(dirs["fit"], "export")
    fit_draft, _ = W.load_draft(export, tcfg,
                                base_embed=params["target"]["embed_tokens"],
                                dtype=dtype, device=device)
    cast = {k: TTR.tree_map(lambda t: t.detach().to(dtype), v)
            for k, v in trainer.params.items() if k != "embed_tokens"}
    diff = _bitwise_diff("export", {k: v for k, v in fit_draft.items()
                                    if k != "embed_tokens"}, cast)
    if diff:
        bad.append(f"fit: the loaded export differs from the trainer's "
                   f"{dtype} cast: {diff}")
    if bad:
        raise AssertionError(f"[train] {bad}")

    # fit's draft served through set_draft on the phase's prompts
    if not TASK_REGISTRY:
        register_builtin_tasks()
    task = get_task("synthetic_vqa")
    eng = checkpoint_engine(dcfg, {})
    gen = MSDGenerator(params["target"], fit_draft, tcfg, dcfg, eng,
                       n_img=n_img, eos_id=tok.eos_token_id, device=device)
    lm = LlavaMSD.from_llava(gen, tok, lp, lcfg)
    docs = task.load_docs(limit=pipe_limit)
    prompts = [lm._prepare(task.doc_to_text(d), task.doc_to_visual(d))
               for d in docs]
    g = torch.Generator(device=device).manual_seed(1234)
    null = D.init_draft_params(dcfg, g, device, dtype)
    null["embed_tokens"] = params["target"]["embed_tokens"]

    def timed_steps(ft, batches, label, after=None):
        """(loss, seconds) of one ``ft.step`` per batch (``float`` of the
        loss waits for the device); ``after()`` runs after each step,
        outside the timed span."""
        rows = []
        for b in batches:
            with Timer(label) as tm:
                loss = float(ft.step(b)["loss"])
            rows.append((loss, tm.elapsed))
            if after is not None:
                after()
        return rows

    def served(gen, draft, prompts, label):
        """Each prompt's tokens under ``draft`` and under the null draft
        (the canonical greedy AR of this verify shape), both installed by
        ``set_draft``; the draft's alpha. Fails unless equal."""
        runs = {}
        for name, d in (("draft", draft), ("null", null)):
            gen.set_draft(d)
            runs[name] = [gen.generate(ids, feats, max_new)
                          for ids, feats in prompts]
        same = [np.array_equal(a.tokens, b.tokens)
                for a, b in zip(runs["draft"], runs["null"])]
        if not all(same):
            raise AssertionError(f"[train] {label}: MSD tokens differ from "
                                 f"the null-draft tokens: {same}")
        rs = runs["draft"]
        return sum(r.accept_len_sum for r in rs) / max(
            sum(r.accept_steps for r in rs), 1)

    out["alpha_fit"] = served(gen, fit_draft, prompts, "fit's draft")
    log(f"[train] fit: {len(steps)} steps at batch 2 over {n_text} text + "
        f"{n_vis} image records ({fit_epochs} epochs of the curriculum), "
        f"{out['fit_ms']:.1f} ms/step (Timer, first step excluded), mean "
        f"loss over the {len(text)} text records {first:.4f} (epoch 0) -> "
        f"{second:.4f} (epoch 1); step losses "
        f"{', '.join(f'{x:.3f}' for x in losses)}; CLI call "
        f"{out['fit_s']:.1f}s, peak {out['fit_peak'] / 2**30:.2f} GiB; the "
        f"export loads bitwise the trainer's {dtype} cast; served through "
        f"set_draft on {len(prompts)} synthetic_vqa prompts x {max_new} "
        f"tokens: == null-draft tokens, alpha {out['alpha_fit']:.3f} on "
        f"{card}")
    # one more fit step, profiled
    if on_card:
        recs = [dict(np.load(os.path.join(dirs[k], n)))
                for k in ("visual", "text")
                for n in sorted(os.listdir(dirs[k]))]
        batch = next(TTR.batches_from_records(
            trainer._prepadded(recs), 2, np.random.default_rng(0)))
        out["fit_profile"] = device_profile(
            lambda: train_step(trainer.params, trainer.opt, dcfg,
                               trainer.tc.train, trainer.head_w, batch,
                               trainer.rng, trainer.cos_t, trainer.sin_t),
            "[train] one fit step (batch 2)")
    del trainer, gen, lm, fit_draft, cast
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    # 3. stage 1: the projector alone
    ft_recs = {}
    for pad in sorted({pad_to, ft2_pad}):
        rs = []
        for r, im in zip(vis, images):
            px = torch.from_numpy(process_image(im)).to(device)
            with torch.no_grad():
                cf = clip_encode(params["vision"], lcfg.vision,
                                 px).float().cpu().numpy()
            rs.append(FT.make_finetune_record(tok, TM._turns(r), cf, n_img,
                                              pad, system=""))
        ft_recs[pad] = rs
    if any(float(r["tgt_mask"].sum()) == 0 for rs in ft_recs.values()
           for r in rs):
        raise AssertionError("[train] a finetune record has no target row")
    bundle = {"target": params["target"], "projector": params["projector"]}
    t1 = time.perf_counter()
    snap = host_snapshot(bundle["target"])
    out["snapshot_s"] = time.perf_counter() - t1
    proj0 = {k: t.clone() for k, t in bundle["projector"].items()}
    fc1 = FT.FinetuneConfig(lr=1e-3, warmup_steps=1, total_steps=ft1_steps,
                            tune_mm_mlp_adapter=True)
    brng = np.random.default_rng(1)
    batches = []
    while len(batches) < ft1_steps:
        batches += list(FT.batches_from_finetune_records(
            ft_recs[pad_to], 2, brng, n_img, lcfg.mm_hidden_size,
            device=device))
    batches = batches[:ft1_steps]
    recompute = finetune_recompute_loss(bundle, tcfg, batches[0], n_img)
    peak_reset()
    ft = FT.LlavaFinetuner(tcfg, bundle, n_img, fc1,
                           max_exp_len=pad_to + n_img - 1)
    st1 = timed_steps(ft, batches, "stage 1")
    out["ft1_peak"] = peak()
    out["ft1_loss"] = [s[0] for s in st1]
    out["ft1_ms"] = 1e3 * float(np.mean([s[1] for s in st1[1:]]))
    t1 = time.perf_counter()
    moved_lm = frozen_lm_check(bundle["target"], snap)
    out["frozen_check_s"] = time.perf_counter() - t1
    proj_moved = [k for k, t in bundle["projector"].items()
                  if not torch.equal(t, proj0[k])]
    rel = abs(out["ft1_loss"][0] - recompute) / abs(recompute)
    out["ft1_recompute"] = (out["ft1_loss"][0], recompute, rel)
    if moved_lm or len(proj_moved) != len(proj0) or not rel <= 1e-3 \
            or not np.isfinite(out["ft1_loss"]).all():
        raise AssertionError(
            f"[train] stage 1: LM tensors moved {moved_lm}; projector "
            f"tensors moved {proj_moved} of {sorted(proj0)}; first-step loss "
            f"{out['ft1_loss'][0]:.6f} against the recompute {recompute:.6f}"
            f" (relative {rel:.2e}, allowed 1e-3); losses {out['ft1_loss']}")
    log(f"[train] stage 1 (tune_mm_mlp_adapter): {len(batches)} steps at "
        f"batch 2 x {pad_to + n_img - 1} rows, {out['ft1_ms']:.1f} ms/step "
        f"(Timer, first step excluded), losses "
        f"{', '.join(f'{x:.4f}' for x in out['ft1_loss'])}; every LM tensor "
        f"bitwise its host snapshot (snapshot {out['snapshot_s']:.1f}s, "
        f"check {out['frozen_check_s']:.1f}s), all {len(proj0)} projector "
        f"tensors moved; first-step loss {out['ft1_loss'][0]:.6f} against "
        f"the eager recompute {recompute:.6f} (relative {rel:.2e}, allowed "
        f"1e-3); peak {out['ft1_peak'] / 2**30:.2f} GiB on {card}")
    del ft

    # the planted fault: stage 1 with the LM's set_to_zero dropped
    ft = FT.LlavaFinetuner(tcfg, bundle, n_img, fc1,
                           max_exp_len=ft2_pad + n_img - 1)
    ft.opt = FT.make_finetune_optimizer(
        dataclasses.replace(fc1, tune_mm_mlp_adapter=False), bundle)
    fb = list(FT.batches_from_finetune_records(
        ft_recs[ft2_pad], 1, np.random.default_rng(2), n_img,
        lcfg.mm_hidden_size, device=device))[:2]
    for b in fb:
        ft.step(b)
    planted = frozen_lm_check(bundle["target"], snap)
    del ft
    gc.collect()
    out["planted_moved"] = len(planted)
    if not planted:
        raise AssertionError("[train] the planted fault (a stage-1 "
                             "optimizer that also updates the LM) passed "
                             "the frozen-LM gate")
    log(f"[train] planted fault (stage 1, set_to_zero dropped, 2 steps): "
        f"the frozen-LM gate rejects it ({len(planted)} of {len(snap)} LM "
        f"tensors moved) on {card}")
    del snap
    for t in _flat_tensors(bundle).values():
        t.requires_grad_(False)
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    # 4. stage 2: the full finetune, bf16 parameters, gradients and moments
    fc2 = FT.FinetuneConfig(warmup_steps=1, total_steps=ft2_steps)
    batches = list(FT.batches_from_finetune_records(
        ft_recs[ft2_pad], 1, np.random.default_rng(3), n_img,
        lcfg.mm_hidden_size, device=device))[:ft2_steps]
    layers = bundle["target"]["layers"]
    watch = {k: w[0].clone() for k, w in layers.items() if w.dim() == 3}
    emb0 = bundle["target"]["embed_tokens"].clone()
    used = torch.unique(torch.cat([b.ids.flatten() for b in batches])
                        .clamp(min=0).long())
    peak_reset()
    ft = FT.LlavaFinetuner(tcfg, bundle, n_img, fc2,
                           max_exp_len=ft2_pad + n_img - 1)
    moved = []
    st2 = timed_steps(ft, batches, "stage 2", after=lambda: moved.append(
        {k: float((layers[k][0] != w).float().mean())
         for k, w in watch.items()}))
    out["ft2_peak"] = peak()
    out["ft2_loss"] = [s[0] for s in st2]
    out["ft2_ms"] = 1e3 * float(np.mean([s[1] for s in st2[1:]]))
    out["ft2_moved"] = moved[1] if len(moved) > 1 else {}
    keep = torch.ones(emb0.shape[0], dtype=torch.bool, device=emb0.device)
    keep[used.to(emb0.device)] = False
    emb_same = torch.equal(bundle["target"]["embed_tokens"][keep], emb0[keep])
    if any(moved[0].values()) or len(moved) < 2 \
            or not all(moved[1].values()) or not emb_same \
            or not np.isfinite(out["ft2_loss"]).all():
        raise AssertionError(
            f"[train] stage 2: share of layer-0 elements moved by update 0 "
            f"(lr 0) {moved[0]}, by update 1 {moved[1:2]}; embed rows of "
            f"unused ids unchanged {emb_same}; losses {out['ft2_loss']}")
    if on_card:
        out["ft2_profile"] = device_profile(
            lambda: ft.step(batches[-1]),
            f"[train] one stage-2 step (batch 1 x {ft2_pad + n_img - 1} rows)")
    log(f"[train] stage 2 (full finetune, {dtype} parameters, gradients "
        f"and AdamW moments, no master copy): {len(batches)} steps at "
        f"batch 1 x {ft2_pad + n_img - 1} rows, {out['ft2_ms']:.1f} ms/step (Timer, "
        f"first step excluded), losses "
        f"{', '.join(f'{x:.4f}' for x in out['ft2_loss'])}; update 0 (lr 0) "
        f"left the LM bitwise, update 1 moved every layer-0 projection "
        f"(share of elements moved: "
        f"{', '.join(f'{k} {v:.3f}' for k, v in out['ft2_moved'].items())}"
        f"); the {int(keep.sum())} embed rows of ids no batch holds bitwise "
        f"unchanged; peak {out['ft2_peak'] / 2**30:.2f} GiB on {card}")
    del ft, bundle, params, lp, watch, emb0, batches
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    # 5. the pipeline over the checkpoint and fit's export
    t1 = time.perf_counter()
    lm, res = TM.main(["pipeline", "--basepath", ckpt, "--msd-model-path",
                       export, "--tasks", "synthetic_vqa", "--distill-docs",
                       str(pipe_docs), "--distill-steps", str(pipe_steps),
                       "--limit", str(pipe_limit), "--device", str(device)])
    out["pipeline_s"] = time.perf_counter() - t1
    out["alpha_pipeline"] = res["msd_stats"]["avg_accept_len"]
    distilled = lm.gen.params["draft"]
    null["embed_tokens"] = lm.gen.params["target"]["embed_tokens"]
    prompts = [lm._prepare(task.doc_to_text(d), task.doc_to_visual(d))
               for d in docs]
    out["alpha_distilled"] = served(lm.gen, distilled, prompts,
                                    "the pipeline's distilled draft")
    log(f"[train] pipeline (distill {pipe_docs} synthetic_vqa docs, "
        f"{pipe_steps} steps, evaluate {pipe_limit}): {out['pipeline_s']:.1f}"
        f"s with the checkpoint load; its msd_stats alpha "
        f"{out['alpha_pipeline']:.3f}; the distilled draft through set_draft"
        f" on the {len(prompts)} prompts x {max_new} tokens: == null-draft "
        f"tokens, alpha {out['alpha_fit']:.3f} (fit's draft) -> "
        f"{out['alpha_distilled']:.3f} (distilled) on {card}")
    del lm, res, distilled, null
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    out["launches"] = K1.decode_attention.launches
    out["captured"] = K1.decode_attention.captured
    if out["launches"] or out["captured"]:
        raise AssertionError(f"[train] K1 ran in the phase: "
                             f"{out['launches']} launches, "
                             f"{out['captured']} captured")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[train] K1 launches 0; phase {out['seconds']:.1f}s on {card}")
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
    # the checkpoint [weights] writes lives until [train] has run on it
    root = tempfile.mkdtemp(prefix="msd_ckpt_")
    try:
        run_all(root)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def run_all(root: str):
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
    serve = run_serve(res)
    k1["serve_launches"] = serve["serve_launches"]
    weights = run_weights(res, serve, root=root)
    harness = run_harness(res, weights["ckpt"], weights["draft"], root)
    harness_ext = run_harness_ext(res, weights["ckpt"], weights["draft"],
                                  root)
    k1["weights_launches"] = weights["launches"]
    k1["harness_launches"] = harness["launches"]
    k1["harness_ext_launches"] = harness_ext["launches"]
    k1["harness_ext_launches_by_task"] = harness_ext["k1_by_task"]
    quant = run_quant(res)
    k1["quant_launches"] = {label: quant[label]["launches"]
                            for label in ("int8 target", "int4 target",
                                          "int8 draft")}
    multi = run_multi(res, serve)
    k1["multi_ar"]["two-image"]["launches"] = multi["launches_by"]["a"]
    k1["multi_ar"]["anyres"]["launches"] = multi["launches_by"]["b"]
    k1["multi_launches"] = multi["launches"]
    profile_k1()
    res["profile"]()
    sampling["profile"]()
    distill["profile"]()
    eagle["profile"]()
    serve["profile"]()
    log(f"[serve] on {card}: CLIP {serve['clip_ms']:.2f} ms per image; "
        + "; ".join(f"B={b} on {v['lanes']} lanes: {v['ms_step']:.2f} "
                    f"ms/step wall, {v['replay_ms']:.3f} ms/step replayed, "
                    f"{v['tok_s']:.1f} tokens/s, batched == solo "
                    f"{all(v['solo'])}"
                    for b, v in serve["batch"].items())
        + f"; B=3 on 3 lanes {serve['unpadded_3_ms']:.3f} ms/step replayed"
        + "".join(f"; {n} lanes, per-lane products "
                  f"{serve['batch'][n]['per_lane']}: {v['per_lane']:.3f} "
                  f"ms/step replayed, {v['one_product']:.3f} without"
                  for n, v in serve["route"].items())
        + f"; continuous: {serve['continuous']['segments']} segments, "
        f"{serve['continuous']['joins']} joins, "
        f"{serve['continuous']['tok_s']:.1f} tokens/s, idle share "
        f"{serve['continuous']['idle']:.3f}, == solo "
        f"{all(serve['continuous']['solo'])}")
    # the 7B weights and generators go before the 13B model comes
    del res, sampling, distill, eagle, serve
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[train] {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated "
        f"after the 7B phases are released")
    train = run_train(weights["ckpt"], root)
    shutil.rmtree(root, ignore_errors=True)
    k1["train_launches"] = train["launches"]
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[13b] {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated "
        f"after the training phase")
    big = run_13b()
    k1["launches_13b"] = big["launches"]
    k1["ar_13b"] = dict(big["k1_row"], launches=big["launches"])
    log(f"[quant] on {card}: per replayed AR token / verify step (ms): "
        f"bf16 {quant['bf16']['ar_replay_ms']:.3f} / "
        f"{quant['bf16']['step_replay_ms']:.3f}; "
        + "; ".join(f"{label} {quant[label]['ar_replay_ms']:.3f} / "
                    f"{quant[label]['step_replay_ms']:.3f} (peak "
                    f"{quant[label]['peak'] / 2**30:.2f} GiB)"
                    for label in ("int8 target", "int4 target",
                                  "int8 draft"))
        + f"; 13B int8 {big['ar_replay_ms']:.3f} / "
        f"{big['step_replay_ms']:.3f} (peak {big['peak'] / 2**30:.2f} GiB);"
        f" K1 {k1['ms'] * 1e3:.2f} us at 32 heads, "
        f"{k1['ar_13b']['ms'] * 1e3:.2f} us at 40 (sdpa "
        f"{k1['ar_13b']['library_ms'] * 1e3:.2f}); checkpoint write "
        f"{weights['write_s']:.1f}s, load "
        f"{weights['load_s']:.1f}s")
    # the 13B model goes before Qwen2-VL comes
    del big
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[qwen] {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated "
        f"after the 13B phase is released")
    root = tempfile.mkdtemp(prefix="msd_qwen_")
    try:
        qwen = run_qwen(root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    k1["qwen_ar"]["launches"] = qwen["launches"]
    k1["qwen_ar"]["harness_launches"] = qwen["harness_launches"]
    k1["qwen_ar"]["harness_launches_by_task"] = qwen["k1_by_task"]
    k1["video_ar"]["launches"] = qwen["video"]["launches"]
    # Qwen2-VL's weights go before Qwen-VL v1 comes (run_qwen's locals)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[qwen_v1] {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
        f"allocated after the Qwen2-VL phase is released")
    root = tempfile.mkdtemp(prefix="msd_qwen_v1_")
    try:
        v1 = run_qwen_v1(root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    k1["qwen_v1_ar"] = dict(v1["k1_row"], launches=v1["launches"],
                            harness_launches=v1["harness_launches"])
    log(f"[qwen_v1] on {card}: AR token {v1['ar_replay_ms']:.3f} ms "
        f"replayed ({v1['ar_ms']:.2f} ms/token wall), verify step "
        f"{v1['step_replay_ms']:.3f} ms replayed ({v1['msd_ms_step']:.2f} "
        f"ms/step wall, eager {v1['eager_ms_step']:.2f}); tower "
        f"{v1['tower_ms']:.2f} ms per 448px image (relative error "
        f"{v1['tower_rel']:.3e}, fault (b) {v1['fault_b_rel']:.3e}); "
        f"checkpoint write {v1['write_s']:.1f}s, load {v1['load_s']:.1f}s;"
        f" harness ms per token A {v1['ms_token']['A']:.2f}, B "
        f"{v1['ms_token']['B']:.2f}; K1 at the v1 row "
        f"{k1['qwen_v1_ar']['ms'] * 1e3:.2f} us (sdpa "
        f"{k1['qwen_v1_ar']['library_ms'] * 1e3:.2f}, bound "
        f"{k1['qwen_v1_ar']['bound_ms'] * 1e3:.2f}); peak "
        f"{v1['peak'] / 2**30:.2f} GiB; phase {v1['seconds']:.1f}s")
    log(f"[qwen] on {card}: AR token {qwen['ar_replay_ms']:.3f} ms "
        f"replayed ({qwen['ar_ms']:.2f} ms/token wall), verify step "
        f"{qwen['step_replay_ms']:.3f} ms replayed ({qwen['msd_ms_step']:.2f}"
        f" ms/step wall, eager {qwen['eager_ms_step']:.2f}); tower "
        f"{qwen['tower_ms']:.2f} ms per image; checkpoint write "
        f"{qwen['write_s']:.1f}s, load {qwen['load_s']:.1f}s; harness ms "
        f"per token A {qwen['ms_token']['A']:.2f}, B "
        f"{qwen['ms_token']['B']:.2f}, D {qwen['ms_token']['D']:.2f}; K1 "
        f"at G*T = 7 {k1['qwen_ar']['ms'] * 1e3:.2f} us (bound "
        f"{k1['qwen_ar']['bound_ms'] * 1e3:.2f}); peak "
        f"{qwen['peak'] / 2**30:.2f} GiB; phase {qwen['seconds']:.1f}s")
    v = qwen["video"]
    log(f"[multi] on {card}: prefill ms " + ", ".join(
        f"{k} {x:.2f}" for k, x in multi["prefill_ms"].items())
        + f"; replayed verify step {multi['step_replay_ms']:.3f} ms, AR "
        f"token {multi['ar_replay_ms']:.3f} ms; prep per 336px image native "
        f"{multi['prep_ms']['native']:.2f} ms, PIL "
        f"{multi['prep_ms']['pil']:.2f} ms; towers " + ", ".join(
            f"{k} {x:.2f} ms" for k, x in multi["tower_ms"].items())
        + f"; peak {multi['peak'] / 2**30:.2f} GiB; phase "
        f"{multi['seconds']:.1f}s. [video]: tower {v['tower_ms']:.2f} ms "
        f"per {VIDEO_FRAMES}-frame video (peak "
        f"{v['tower_peak'] / 2**30:.2f} GiB above the weights), prefill "
        f"{v['prefill_ms']:.2f} ms, replayed verify step "
        f"{v['step_replay_ms']:.3f} ms, AR token {v['ar_replay_ms']:.3f} ms;"
        f" K1 at the new rows (us, kernel / sdpa / bound): " + "; ".join(
            f"{k} {e['ms'] * 1e3:.2f} / {e['library_ms'] * 1e3:.2f} / "
            f"{e['bound_ms'] * 1e3:.2f}" for k, e in
            list(k1["multi_ar"].items()) + [("video", k1["video_ar"])]))
    log(f"[train] on {card}: fit {train['fit_ms']:.1f} ms/step, stage 1 "
        f"{train['ft1_ms']:.1f} ms/step, stage 2 {train['ft2_ms']:.1f} "
        f"ms/step; records/s "
        + ", ".join(f"{k} {v:.1f}" for k, v in train['records_per_s'].items())
        + f"; pipeline {train['pipeline_s']:.1f}s, alpha "
        f"{train['alpha_fit']:.3f} (fit's draft) -> "
        f"{train['alpha_distilled']:.3f} (distilled; its msd_stats "
        f"{train['alpha_pipeline']:.3f}); peak GiB fit "
        f"{train['fit_peak'] / 2**30:.2f}, stage 1 "
        f"{train['ft1_peak'] / 2**30:.2f}, stage 2 "
        f"{train['ft2_peak'] / 2**30:.2f}; phase {train['seconds']:.1f}s")
    log(f"[done] total wall {time.perf_counter() - t_start:.1f}s on {card}")
    print(json.dumps({"kernels": [k1]}), flush=True)
    print(smi_name_and_limit(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
