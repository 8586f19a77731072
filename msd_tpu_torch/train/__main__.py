"""CLI: draft-head training, teacher-state generation, the distill ->
evaluate pipeline and LLaVA finetuning. The port of the JAX package's
``python -m msd_tpu.train``, with its subcommands and flags plus
``--device`` (default ``cuda``; bf16 weights on a CUDA device, fp32
elsewhere, as ``serve.server.main`` loads them).

Usage (main_deepspeed.py analog):
  python -m msd_tpu_torch.train fit --basepath /ckpt/llava-7b \\
      --tmpdir_v data/visual --tmpdir_t data/text --cpdir checkpoints/draft

  python -m msd_tpu_torch.train gen-data --basepath /ckpt/llava-7b \\
      --data llava_instruct.json --outdir data/visual --start 0 --end 10000

  python -m msd_tpu_torch.train pipeline --basepath /ckpt/llava-7b \\
      --msd-model-path checkpoints/draft/export --tasks chartqa --limit 64

  python -m msd_tpu_torch.train finetune --basepath /ckpt/llava-7b \\
      --data llava_instruct.json --tune-mm-mlp-adapter

A sample's ``image`` field reaches ``process_image`` as it is, as in the
JAX CLI: an image given as a file path fails there in both CLIs, so
images reach the records through ``generate_dataset`` /
``make_finetune_record`` called in process with arrays. ``fit`` draws the
draft's initial weights from ``torch.Generator`` seed 0 (JAX: PRNGKey(0)).
``main`` returns what its subcommand made (the record count, the trainer,
the finetuner, or the pipeline's adapter and results), for callers in
process.
"""

from __future__ import annotations

import argparse
import json
import os


def _tokenizer(basepath: str, vocab_size: int):
    """The checkpoint's tokenizer when ``transformers`` reads it locally and
    it fits the model's vocabulary, else the byte-level fallback."""
    from msd_tpu_torch.harness.models.llava_msd import SimpleTokenizer

    try:
        from transformers import AutoTokenizer
        tokenizer = AutoTokenizer.from_pretrained(basepath,
                                                  local_files_only=True)
        if tokenizer.vocab_size > vocab_size:
            raise ValueError("tokenizer/model vocab mismatch")
        return tokenizer
    except Exception:  # checkpoint dir without usable tokenizer files
        return SimpleTokenizer(vocab_size=vocab_size)


def _turns(r):
    """LLaVA-instruct format: conversations [{from: human/gpt, value}, ...]
    -> [(user, assistant), ...], the <image> tag taken out."""
    conv = r.get("conversations", [])
    return [(conv[i]["value"].replace("<image>", "").strip(),
             conv[i + 1]["value"])
            for i in range(0, len(conv) - 1, 2)]


def _flat(tree, prefix: str, out: dict) -> dict:
    """float32 numpy leaves of a nested dict under "."-joined keys."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            _flat(v, f"{prefix}.{k}", out)
        else:
            out[f"{prefix}.{k}"] = v.detach().float().cpu().numpy()
    return out


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser("msd_tpu_torch.train")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def device_arg(p):
        p.add_argument("--device", default="cuda",
                       help="torch device: bf16 weights on a CUDA device, "
                            "fp32 elsewhere")

    fit = sub.add_parser("fit")
    fit.add_argument("--basepath", required=True, help="target checkpoint dir")
    fit.add_argument("--tmpdir_v", default=None, help="visual records dir")
    fit.add_argument("--tmpdir_t", default=None, help="text records dir")
    fit.add_argument("--cpdir", default="checkpoints/draft")
    fit.add_argument("--epochs", type=int, default=40)
    fit.add_argument("--bs", type=int, default=2)
    fit.add_argument("--lr", type=float, default=2e-4)
    fit.add_argument("--max-len", type=int, default=2048)
    fit.add_argument("--resume", default=None)
    fit.add_argument("--wandb-project", default=None,
                     help="W&B project (main_deepspeed.py:141-143); no-op "
                          "when wandb is unavailable")
    device_arg(fit)

    pipe = sub.add_parser(
        "pipeline", help="distill the draft on on-policy teacher states, "
        "then evaluate per-task alpha (train/pipeline.py)")
    pipe.add_argument("--basepath", default=None)
    pipe.add_argument("--msd-model-path", dest="msd_model_path", default=None)
    pipe.add_argument("--tiny", action="store_true",
                      help="checkpoint-free tiny stack (pipeline smoke)")
    pipe.add_argument("--tasks", required=True)
    pipe.add_argument("--limit", type=int, default=None)
    pipe.add_argument("--distill-docs", type=int, default=16)
    pipe.add_argument("--distill-steps", type=int, default=200)
    pipe.add_argument("--log-dir", default=None)
    pipe.add_argument("--wandb-project", default=None)
    device_arg(pipe)

    ft = sub.add_parser(
        "finetune", help="LLaVA target finetuning (LLaVA train.py analog): "
        "stage-1 projector pretrain via --tune-mm-mlp-adapter, stage-2 full "
        "finetune; vision tower frozen")
    ft.add_argument("--basepath", required=True, help="target checkpoint dir")
    ft.add_argument("--data", required=True, help="LLaVA-instruct style JSON")
    ft.add_argument("--cpdir", default="checkpoints/finetune")
    ft.add_argument("--epochs", type=int, default=1)
    ft.add_argument("--bs", type=int, default=2)
    ft.add_argument("--lr", type=float, default=2e-5)
    ft.add_argument("--mm-projector-lr", type=float, default=None)
    ft.add_argument("--tune-mm-mlp-adapter", action="store_true")
    ft.add_argument("--freeze-backbone", action="store_true")
    ft.add_argument("--pad-to", type=int, default=512)
    ft.add_argument("--no-image", action="store_true")
    device_arg(ft)

    gen = sub.add_parser("gen-data")
    gen.add_argument("--basepath", required=True)
    gen.add_argument("--data", required=True, help="LLaVA-instruct style JSON")
    gen.add_argument("--outdir", required=True)
    gen.add_argument("--start", type=int, default=0)
    gen.add_argument("--end", type=int, default=None)
    gen.add_argument("--pad-to", type=int, default=2048)
    gen.add_argument("--no-image", action="store_true")
    device_arg(gen)
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    if args.cmd == "pipeline":
        from msd_tpu_torch.train.pipeline import main_pipeline
        return main_pipeline(args)

    import numpy as np
    import torch

    from msd_tpu_torch.utils.weights import load_llava

    dtype = torch.bfloat16 if torch.device(args.device).type == "cuda" \
        else torch.float32
    params, lcfg = load_llava(args.basepath, dtype, args.device)

    if args.cmd == "finetune":
        from msd_tpu_torch.models.clip_vit import clip_encode
        from msd_tpu_torch.train import finetune as FT
        from msd_tpu_torch.utils.mm_utils import process_image

        tokenizer = _tokenizer(args.basepath, lcfg.text.vocab_size)
        with open(args.data) as f:
            raw = json.load(f)
        n_img = 0 if args.no_image else lcfg.num_image_tokens
        recs = []
        for r in raw:
            feats = None
            if n_img and r.get("image") is not None:
                px = torch.from_numpy(process_image(r["image"])).to(
                    args.device)
                with torch.no_grad():
                    feats = clip_encode(params["vision"], lcfg.vision,
                                        px).float().cpu().numpy()
            rec = FT.make_finetune_record(tokenizer, _turns(r), feats,
                                          n_img, pad_to=args.pad_to)
            if float(rec["tgt_mask"].sum()) > 0:
                recs.append(rec)
        if len(recs) < args.bs:
            raise SystemExit(
                f"finetune: only {len(recs)} usable records (< batch size "
                f"{args.bs}) — answers truncated away? raise --pad-to")
        fc = FT.FinetuneConfig(
            lr=args.lr, mm_projector_lr=args.mm_projector_lr,
            tune_mm_mlp_adapter=args.tune_mm_mlp_adapter,
            freeze_backbone=args.freeze_backbone,
            total_steps=max(args.epochs * len(recs) // args.bs, 1))
        bundle = {"target": params["target"],
                  "projector": params["projector"]}
        del params
        ft = FT.LlavaFinetuner(lcfg.text, bundle, n_img, fc,
                               max_exp_len=args.pad_to + max(n_img - 1, 0))
        rng = np.random.default_rng(0)
        for ep in range(args.epochs):
            m = ft.run(FT.batches_from_finetune_records(
                recs, args.bs, rng, n_img, lcfg.mm_hidden_size,
                device=args.device))
            print(f"epoch {ep}: " + " ".join(f"{k}={v:.4f}"
                                             for k, v in m.items()))
        os.makedirs(args.cpdir, exist_ok=True)
        flat = {}
        for scope in ("target", "projector"):
            _flat(ft.params[scope], scope, flat)
        out = os.path.join(args.cpdir, "finetuned.npz")
        np.savez(out, **flat)
        print(f"done: {ft.step_count} steps, saved {out}")
        return ft

    if args.cmd == "fit":
        from msd_tpu_torch.configs import DraftConfig
        from msd_tpu_torch.models.draft import init_draft_params
        from msd_tpu_torch.train.draft_train import TrainConfig
        from msd_tpu_torch.train.trainer import TrainerConfig, train_from_dirs
        from msd_tpu_torch.utils.weights import save_draft

        dcfg = DraftConfig(text=lcfg.text)
        g = torch.Generator(device=args.device).manual_seed(0)
        dparams = init_draft_params(dcfg, g, args.device, dtype)
        dparams["embed_tokens"] = params["target"]["embed_tokens"]
        head_w = params["target"]["lm_head"]
        del params
        tc = TrainerConfig(
            train=TrainConfig(lr=args.lr), batch_size=args.bs,
            max_len=args.max_len, num_epochs=args.epochs, ckpt_dir=args.cpdir,
            wandb_project=args.wandb_project)
        trainer = train_from_dirs(dcfg, dparams, head_w,
                                  args.tmpdir_v or "", args.tmpdir_t or "", tc)
        exp = save_draft(trainer.params, os.path.join(args.cpdir, "export"))
        print(f"done: {trainer.step_count} steps, saved under {args.cpdir}; "
              f"deployable draft at {exp}")
        return trainer

    from msd_tpu_torch.models.llava import encode_image
    from msd_tpu_torch.train.data_gen import generate_dataset

    tokenizer = _tokenizer(args.basepath, lcfg.text.vocab_size)
    with open(args.data) as f:
        raw = json.load(f)
    samples = [{"turns": _turns(r), "image": r.get("image")} for r in raw]
    enc = None
    if not args.no_image:
        lp = {"vision": params["vision"], "projector": params["projector"]}

        def enc(px):
            with torch.no_grad():
                return encode_image(lp, lcfg, px)
    n = generate_dataset(params["target"], lcfg.text, tokenizer, samples,
                         args.outdir, encode_image_fn=enc,
                         n_img=0 if args.no_image else lcfg.num_image_tokens,
                         pad_to=args.pad_to, start=args.start, end=args.end)
    print(f"wrote {n} records to {args.outdir}")
    return n


if __name__ == "__main__":
    main()
