"""One chat turn over the MSD engine (the LLaVA/llava/serve/cli.py
protocol).

The port of ``chat_once`` of the JAX package's ``serve/cli.py``: append
the user turn to the vicuna conversation, stream the assistant's reply
from ``generate_stream`` (segments of the same step as a one-shot
``generate``, so the reply is token-identical to it), write the decoded
text to ``out`` as it grows, and append the reply back into the
conversation so the next turn sees it. ``main`` is the interactive
command (the JAX ``serve/cli.py``: a checkpoint or a random tiny stack,
an optional image for the first turn, a read-reply loop):

  python -m msd_tpu_torch.serve.cli --pretrained <ckpt> \
      --msd_model_path <draft> [--image photo.jpg] [--temperature 0.2]
  python -m msd_tpu_torch.serve.cli --tiny        # random tiny stack

Type a message and press enter; 'exit' or EOF quits.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from msd_tpu_torch.configs import DEFAULT_IMAGE_TOKEN
from msd_tpu_torch.utils.conversation import vicuna_v1
from msd_tpu_torch.utils.mm_utils import tokenizer_image_token


def chat_once(adapter, conv, text: str, feats, sp, max_new: int,
              out=None) -> str:
    """Run one user turn through the conversation and the engine; returns
    the assistant reply (and streams segments to ``out`` as they decode).
    ``feats``: the image's projected rows (with "<image>" in the first
    user turn) or None."""
    conv.append_message(conv.roles[0], text)
    conv.append_message(conv.roles[1], None)
    prompt = conv.get_prompt()
    ids = tokenizer_image_token(prompt, adapter.tokenizer)
    pieces = []
    prev = ""
    for seg in adapter.gen.generate_stream(np.asarray(ids, np.int32),
                                           img_feats=feats,
                                           max_new_tokens=max_new, sp=sp):
        pieces.extend(list(seg))
        cur = adapter.tokenizer.decode(pieces, skip_special_tokens=True)
        if out is not None:
            out.write(cur[len(prev):])
            out.flush()
        prev = cur
    reply = prev.strip()
    # replace the open slot with the actual reply so the next turn sees it
    conv.messages[-1] = (conv.roles[1], reply)
    return reply


def _load_adapter(args):
    from msd_tpu_torch.serve.adapter import ServeAdapter
    if args.tiny:
        return ServeAdapter.from_tiny(device=args.device,
                                      use_msd=not args.no_msd)
    if not args.pretrained:
        raise SystemExit("--pretrained (or --tiny) is required")
    return ServeAdapter.from_pretrained(args.pretrained, args.msd_model_path,
                                        device=args.device,
                                        use_msd=not args.no_msd,
                                        max_new_tokens=args.max_new_tokens)


def main(argv=None):
    ap = argparse.ArgumentParser("msd_tpu_torch.serve.cli")
    ap.add_argument("--pretrained", default=None)
    ap.add_argument("--msd_model_path", default=None)
    ap.add_argument("--tiny", action="store_true",
                    help="random tiny stack (no checkpoints)")
    ap.add_argument("--image", default=None, help="image file for the chat")
    ap.add_argument("--no-msd", action="store_true",
                    help="plain AR decoding instead of speculative")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top_p", type=float, default=1.0)
    ap.add_argument("--max-new-tokens", type=int, default=512)
    ap.add_argument("--device", default="cuda",
                    help="weights in bf16 on a CUDA device, else fp32")
    args = ap.parse_args(argv)

    adapter = _load_adapter(args)
    sp = adapter.sampling({"temperature": args.temperature,
                           "top_p": args.top_p})
    feats = None
    if args.image:
        from PIL import Image

        from msd_tpu_torch.utils.mm_utils import process_image
        if adapter.encode_image_fn is None:
            raise SystemExit("model has no vision encoder")
        img = np.asarray(Image.open(args.image).convert("RGB"))
        feats = adapter.encode_image_fn(
            process_image(img, image_size=adapter.image_size))

    conv = vicuna_v1()
    first_turn = True
    print("chat ready ('exit' to quit)", file=sys.stderr)
    while True:
        try:
            text = input(f"{conv.roles[0]}: ")
        except EOFError:
            break
        if text.strip().lower() in ("exit", "quit"):
            break
        if not text.strip():
            continue
        if first_turn and feats is not None:
            # the image token goes into the first user message only
            # (llava/serve/cli.py:74-82)
            text = DEFAULT_IMAGE_TOKEN + "\n" + text
        first_turn = False
        sys.stdout.write(f"{conv.roles[1]}: ")
        chat_once(adapter, conv, text, feats, sp, args.max_new_tokens,
                  out=sys.stdout)
        sys.stdout.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
