"""One chat turn over the MSD engine (the LLaVA/llava/serve/cli.py
protocol).

The port of ``chat_once`` of the JAX package's ``serve/cli.py``: append
the user turn to the vicuna conversation, stream the assistant's reply
from ``generate_stream`` (segments of the same step as a one-shot
``generate``, so the reply is token-identical to it), write the decoded
text to ``out`` as it grows, and append the reply back into the
conversation so the next turn sees it. The interactive command (a
checkpoint, an image file, a read-reply loop) comes with the port's
weight loading.
"""

from __future__ import annotations

import numpy as np

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
