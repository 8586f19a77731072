"""chip_smoke's ``[parallel]`` phase on the CPU at a tiny fp32 width: two
gloo ranks for TP=2 decode, the pipeline and sequence parallelism, then
four for TP=4 (``chip_smoke.run_parallel``). The phase raises unless every
gate holds (tokens equal on every rank and to the single-device run, MSD
== null-draft under TP, the first decode row within its bound and the
planted o_proj-sum fault beyond it, the pipeline and sequence outputs
within theirs and bitwise equal on every rank, cuda_graphs over gloo
refused; (f), the batched lanes, the continuous scheduler, calibration,
scoring and a two-image prompt under TP=2 against their solo runs and
the single device; then, in the world of four, the DraftTrainer and LlavaFinetuner
on a (data 2, model 2) mesh within their bounds of one device, and both
planted training faults, *f* the identity and the loss as the mean of
local means, beyond the gradient's). A second world plants splits from
the single-device tokens:
the split gate (``chip_smoke.tp_split_ok``) passes TP's pick at an exact
tie of the single device's row and fails TP with the o_proj sum
skipped."""

import dataclasses

import chip_smoke
from msd_tpu_torch.configs import ClipVisionConfig, LlamaConfig
from tests.test_torch_graphs import one_torch_thread  # noqa: F401 (autouse)


def test_smoke_parallel_phase_at_tiny_size():
    tcfg = dataclasses.replace(LlamaConfig.tiny(
        vocab_size=512, hidden_size=64, layers=2, heads=4,
        intermediate_size=128, max_pos=1024), residual_dtype="float32")
    cfg13 = dataclasses.replace(LlamaConfig.tiny(
        vocab_size=512, hidden_size=80, layers=2, heads=4,
        intermediate_size=128, max_pos=1024), residual_dtype="float32")
    train_cfg = LlamaConfig.tiny(vocab_size=512, hidden_size=64, layers=2,
                                 heads=4, intermediate_size=128,
                                 max_pos=1024)
    out = chip_smoke.run_parallel(
        device="cpu", tcfg=tcfg, cfg13=cfg13, widths=(4, 3, 2, 2, 1),
        max_seq=384, max_new=12, new_13b=8, n_img=16, prompt_tokens=20,
        pp_layers=2, rows=32, micro=2, train_cfg=train_cfg,
        train=dict(chip_smoke.PARALLEL_TRAIN, rows=32, medusa=3,
                   ft_img=16),
        train_vision=ClipVisionConfig.tiny(hidden_size=32))
    assert out["transport"] == "gloo"
    assert out["launches_tp2"] == out["launches_tp4"] == 0  # the CPU twin
    assert out["row_rel"] <= chip_smoke.PARALLEL_ROW_TOL["float32"]
    assert out["fault_rel"] > chip_smoke.PARALLEL_ROW_TOL["float32"]
    assert all(out["same_as_single"].values())
    assert set(out["fwd_rel"]) == {"pipeline", "gather", "ring"}
    t, tol = out["train"], chip_smoke.PARALLEL_TRAIN_TOL
    assert t["grad_rel"] <= tol["grad"] and t["move_rel"] <= tol["move"]
    assert min(t["fault_rel"].values()) > 100 * tol["grad"]
    held, whole, repl = t["zero_bytes"]
    assert 2 * held == whole and repl > whole
    assert t["ft_loss_rel"] <= chip_smoke.PARALLEL_FT_TOL["loss"]
    # (f): the generator's other paths under TP=2
    f = out["paths"]
    assert f["launches"] == 0                            # the CPU twin
    assert all(f["same_as_single"].values())
    assert 0 < f["feature_rel"] <= chip_smoke.PARALLEL_ROW_TOL["float32"]
    assert f["score"]["diff"] <= f["score"]["bound"]
    assert set(f["s"]) == {"batch B=2", "solo p1", "scheduler", "collect",
                           "calibrated", "score", "two-image MSD",
                           "two-image AR"}


SPLIT_CFG = dict(vocab_size=512, hidden_size=64, layers=2, heads=4,
                 intermediate_size=128, max_pos=1024)
SPLIT_WIDTHS, SPLIT_IMG, SPLIT_NEW = (4, 3, 2, 2, 1), 16, 8


def _split_rank(rank, world, store, out_dir):
    """One of two gloo ranks: the single-device AR tokens (rank 0) of a
    target whose every odd vocab column ties its even neighbour, against
    TP=2 AR runs that split from them: TP leaning to the odd token of
    each tie (a rounding tie), and TP with the o_proj sum skipped (a TP
    fault); ``chip_smoke.tp_splits`` of each, written to rank<r>.pt."""
    import os

    import torch
    from msd_tpu_torch.engine.generator import MSDGenerator
    from msd_tpu_torch.parallel.sharding import (draft_param_specs,
                                                 llama_param_specs,
                                                 make_mesh, shard_params)

    chip_smoke._rank_setup(rank, world, store, "cpu")
    tcfg = dataclasses.replace(LlamaConfig.tiny(**SPLIT_CFG),
                               residual_dtype="float32")
    dcfg, tp, drafts = chip_smoke.main_weights(tcfg, SPLIT_WIDTHS, "cpu",
                                               torch.float32)
    tp["lm_head"][:, 1::2] = tp["lm_head"][:, 0::2]
    ids, feats = chip_smoke.main_prompts(tcfg, SPLIT_IMG, 20, "cpu",
                                         torch.float32)
    ids = ids[0]
    eng = chip_smoke.medusa_engine(SPLIT_WIDTHS, 384)
    mesh = make_mesh(world, dp=1, tp=world)

    def make(t, d):
        return MSDGenerator(t, d, tcfg, dcfg, eng, n_img=SPLIT_IMG,
                            eos_id=-1, device="cpu", cuda_graphs=False)

    def sharded(lean):
        tps = shard_params(tp, llama_param_specs(tcfg), mesh)
        tps["lm_head"] = tps["lm_head"] * lean
        dps = shard_params(drafts["msd"], draft_param_specs(dcfg, True),
                           mesh)
        dps["embed_tokens"] = tps["embed_tokens"]
        return make(tps, dps)

    def splits(gen):
        toks = gen.naive_generate(ids, feats, SPLIT_NEW).tokens
        return chip_smoke.tp_splits(gen, single, ref, {"ar": toks}, ids,
                                    feats, SPLIT_NEW)

    single = ref = None
    if rank == 0:
        single = make(tp, drafts["msd"])
        ref = {"ar": single.naive_generate(ids, feats, SPLIT_NEW).tokens}
    lean = torch.ones(tcfg.vocab_size // world)
    lean[1::2] += 2 ** -16
    out = {"tie": splits(sharded(lean))}
    with chip_smoke.o_proj_sum_skipped():
        out["fault"] = splits(sharded(torch.ones(())))
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))


def test_tp_split_gate_passes_a_tie_and_fails_a_tp_fault(tmp_path):
    import torch

    chip_smoke._spawn(_split_rank, 2, str(tmp_path))
    out = torch.load(tmp_path / "rank0.pt", weights_only=False)
    tol = chip_smoke.PARALLEL_ROW_TOL["float32"]
    tie, fault = out["tie"]["ar"], out["fault"]["ar"]
    # TP took the odd token of an exact tie of the single device's row
    assert tie["ulps"] == 0.0 and tie["tp_rel"] <= tol
    assert chip_smoke.tp_split_ok(tie, chip_smoke.HARNESS_TIE, tol)
    # a TP fault cannot widen the gate: its noise is the single device's
    assert fault["tp_rel"] > tol
    assert not chip_smoke.tp_split_ok(fault, chip_smoke.HARNESS_TIE, tol)
    assert torch.load(tmp_path / "rank1.pt", weights_only=False) == {
        "tie": {}, "fault": {}}
