#!/usr/bin/env python3
"""Device time of the port's one-request verify step on one NVIDIA card.

    python3 step_times.py            # from the root of a checkout

Times the captured verify step of ``msd_tpu_torch`` at LLaVA-1.5-7B width
(random weights from seeded generators, the smoke's image prompt of 64
tokens) in three configurations: greedy medusa (the main path's 48-node
tree), sampled medusa (T=1) and EAGLE (top-k 10, depth 8, 96 nodes). For
each: the wall ms/step of three 64-token requests (prefill included) and
the device ms of one step over 16 back-to-back replays between CUDA
events, three times; for greedy medusa also the device time and kernel
count of one replayed step under torch.profiler. It imports the package
from the working directory, so run from the root of an unpacked archive
of another commit it measures that commit: parent, change, change, parent
in one call compares two commits on one card.
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
import time

import numpy as np

WIDTHS = (10, 8, 6, 5, 4, 3, 2, 2, 2, 1, 1, 1, 1, 1)


def main():
    sys.path.insert(0, os.getcwd())
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from msd_tpu_torch.configs import (IMAGE_TOKEN_INDEX, DraftConfig,
                                       EngineConfig, LlamaConfig, TreeConfig)
    from msd_tpu_torch.engine.generator import MSDGenerator
    from msd_tpu_torch.models import draft as D
    from msd_tpu_torch.models import llama as L
    from msd_tpu_torch.ops.sampling import SamplingParams

    if not torch.cuda.is_available():
        raise SystemExit("step_times: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev, bf16 = "cuda", torch.bfloat16
    tcfg = dataclasses.replace(LlamaConfig.llava_7b(),
                               residual_dtype="float32")
    tp = L.init_llama_params(tcfg, torch.Generator(device=dev).manual_seed(0),
                             dev, bf16)
    tp["lm_head"].mul_(6.0)
    rng = np.random.default_rng(0)
    ids = rng.integers(3, 31000, size=64).astype(np.int32)
    ids[1] = IMAGE_TOKEN_INDEX
    feats = torch.from_numpy(rng.normal(size=(576, 4096)) * 0.02).to(
        dev, bf16)
    medusa = TreeConfig(top_k=10, max_depth=len(WIDTHS),
                        num_nodes=1 + sum(WIDTHS), medusa_widths=WIDTHS)
    eagle = TreeConfig(top_k=10, max_depth=8, num_nodes=96)
    greedy = SamplingParams(greedy_round_bits=6)
    tree_name = os.path.basename(os.getcwd())
    for name, heads, tree, sp in (
            ("medusa greedy", len(WIDTHS) - 1, medusa, greedy),
            ("medusa T=1", len(WIDTHS) - 1, medusa,
             SamplingParams(temperature=1.0)),
            ("eagle greedy", 0, eagle, greedy)):
        dcfg = DraftConfig(text=tcfg, medusa_heads=heads)
        g = torch.Generator(device=dev).manual_seed(1)
        dp = D.init_draft_params(dcfg, g, dev, bf16)
        if heads:
            dp["medusa"] = D.init_medusa_params(dcfg, g, dev, bf16)
        dp["embed_tokens"] = tp["embed_tokens"]
        gen = MSDGenerator(tp, dp, tcfg, dcfg,
                           EngineConfig(max_seq_len=1152,
                                        prompt_pad_multiple=128, tree=tree),
                           n_img=576, eos_id=-1, sp=sp, device=dev)
        gen.generate(ids, feats, 4, seed=17)   # captures the step
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = gen.generate(ids, feats, 64, seed=17)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3 / r.accept_steps)
        step = gen.graphs.steps[r.graph]
        device = []
        for _ in range(3):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            for _ in range(16):
                step()
            end.record()
            end.synchronize()
            device.append(start.elapsed_time(end) / 16)
        line = (f"[steps] {tree_name} {name}: wall ms/step "
                f"{['%.2f' % w for w in walls]}, replayed device ms/step "
                f"{['%.3f' % d for d in device]}")
        if name == "medusa greedy":
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(8):
                    step()
                torch.cuda.synchronize()
            kernels = [e for e in prof.events()
                       if e.device_type == DeviceType.CUDA]
            us = sum(e.time_range.end - e.time_range.start for e in kernels)
            line += (f"; profiled {us / 8e3:.3f} ms, {len(kernels) / 8:.0f} "
                     f"kernels per step")
        print(line, flush=True)
        del gen, step
        torch.cuda.empty_cache()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
