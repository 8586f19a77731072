"""Minimal HTTP serving layer over the MSD engine (stdlib only).

The port of the JAX package's ``serve/server.py``: one worker thread owns
the card (it does every prefill, image encode, graph capture and replay;
the HTTP threads only enqueue work and wait), with two scheduling
upgrades over a one-request-at-a-time worker:

- micro-batching: compatible queued /generate requests (same sampling
  parameters and limits, all with or all without an image) are served
  together as the lanes of one batched step (``generate_batch``);
- streaming: /generate_stream emits newline-delimited JSON chunks, one per
  segment of ``decode_until``, token-identical to the non-streaming path;
- continuous batching (``continuous=N``): requests join and leave a
  running N-slot batch at segment boundaries (``serve/continuous.py``),
  image and text prompts mixed, streaming and non-streaming slots side by
  side.

  POST /generate        {"prompt": str, "image_b64"?: str,
                         "max_new_tokens"?: int, "temperature"?: float,
                         "top_p"?: float, "use_msd"?: bool, "seed"?: int}
  POST /generate_stream same body; response is chunked JSONL:
                        {"text": "..."} per segment, {"done": true, ...} last
  GET  /health          {"status": "ok", ...}

An image request goes through ``process_image``, the adapter's image
encoder (the CLIP tower and projector) and the vicuna_v1 prompt with the
<image> placeholder; an adapter without an encoder answers it with an
error. A request's sampling parameters are the generator's with the
request's temperature and top_p. ``use_msd: false`` decodes with the AR
baseline. Build the adapter (``harness/models/llava_msd.LlavaMSD``) and
call ``serve_forever(adapter, port)``, then ``serve_forever()`` on the
returned server, or serve a checkpoint from the command line:

  python -m msd_tpu_torch.serve.server --pretrained <llava dir> \
      --msd_model_path <draft dir> [--port 8399] [--continuous N]
"""

from __future__ import annotations

import base64
import io
import json
import queue
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

MAX_MICROBATCH = 8


class _Work:
    def __init__(self, payload, stream: bool = False):
        self.payload = payload
        self.stream = stream
        self.done = threading.Event()
        self.result = None
        self.error: Optional[str] = None
        # streaming works receive text chunks here; None terminates
        self.chunks: "queue.Queue" = queue.Queue() if stream else None

    def fail(self, error: str) -> None:
        self.error = error
        if self.chunks is not None:
            self.chunks.put(None)
        self.done.set()


def decode_image(b64: str) -> np.ndarray:
    """A base64 image file (PNG, JPEG, ...) -> HWC uint8 RGB."""
    from PIL import Image

    img = Image.open(io.BytesIO(base64.b64decode(b64)))
    return np.asarray(img.convert("RGB"))


class EngineWorker(threading.Thread):
    """Single thread owning the generator; serializes card access and
    micro-batches compatible queued requests."""

    def __init__(self, adapter):
        super().__init__(daemon=True)
        self.adapter = adapter
        self.q: "queue.Queue[_Work]" = queue.Queue()
        self.served = 0
        self.batches = 0
        self._stop_event = threading.Event()

    def stop(self) -> None:
        """End the loop after the work in hand."""
        self._stop_event.set()
        self.q.put(None)

    # -- request prep -------------------------------------------------
    def _prep(self, p):
        """payload -> (ids, feats, sp, max_new, use_msd)."""
        from msd_tpu_torch.utils.conversation import build_msd_prompt
        from msd_tpu_torch.utils.mm_utils import (process_image,
                                                  tokenizer_image_token)

        adapter = self.adapter
        feats = None
        with_image = bool(p.get("image_b64"))
        if with_image:
            if adapter.encode_image_fn is None:
                raise ValueError("this model has no vision encoder: image "
                                 "requests are refused")
            px = process_image(decode_image(p["image_b64"]),
                               image_size=adapter.image_size)
            feats = adapter.encode_image_fn(px)
        prompt = build_msd_prompt(p["prompt"], with_image=with_image)
        ids = tokenizer_image_token(prompt, adapter.tokenizer)
        sp = adapter.sampling(p)
        max_new = int(p.get("max_new_tokens", 256))
        use_msd = bool(p.get("use_msd", True)) and adapter.use_msd
        return ids, feats, sp, max_new, use_msd

    @staticmethod
    def _batch_key(p):
        return (float(p.get("temperature", 0.0)), float(p.get("top_p", 1.0)),
                int(p.get("max_new_tokens", 256)),
                bool(p.get("use_msd", True)), bool(p.get("image_b64")))

    def _drain_compatible(self, first: _Work):
        """Pull queued non-streaming works sharing first's batch key."""
        group, leftover = [first], []
        key = self._batch_key(first.payload)
        while len(group) < MAX_MICROBATCH:
            try:
                w = self.q.get_nowait()
            except queue.Empty:
                break
            if w is not None and not w.stream \
                    and self._batch_key(w.payload) == key:
                group.append(w)
            else:
                leftover.append(w)
        for w in leftover:  # preserve arrival order for incompatible works
            self.q.put(w)
        return group

    # -- main loop ----------------------------------------------------
    def run(self):
        while not self._stop_event.is_set():
            w = self.q.get()
            if w is None:
                continue
            batchable = (not w.stream
                         and bool(w.payload.get("use_msd", True))
                         and self.adapter.use_msd)
            group = self._drain_compatible(w) if batchable else [w]
            try:
                if len(group) > 1:
                    self._handle_group(group)
                elif w.stream:
                    self._handle_stream(w)
                    self.served += 1
                else:
                    w.result = self._handle(w.payload)
                    self.served += 1
                    w.done.set()
            except Exception as e:  # surfaced to the client(s)
                for g in group:
                    g.fail(f"{type(e).__name__}: {e}")

    def _decode_result(self, tokens, dt, r=None):
        text = self.adapter.tokenizer.decode(list(tokens),
                                             skip_special_tokens=True)
        return {
            "text": text.strip(),
            "tokens_generated": int(len(tokens)),
            "seconds": dt,
            "tokens_per_second": len(tokens) / max(dt, 1e-9),
            "avg_accept_len": getattr(r, "avg_accept_len", None),
        }

    def _handle(self, p):
        ids, feats, sp, max_new, use_msd = self._prep(p)
        t0 = time.time()
        fn = (self.adapter.gen.generate if use_msd
              else self.adapter.gen.naive_generate)
        r = fn(ids, img_feats=feats, max_new_tokens=max_new, sp=sp,
               seed=int(p.get("seed", 0)))
        return self._decode_result(r.tokens, time.time() - t0, r)

    def _handle_group(self, group):
        """Serve compatible requests as the lanes of one batched step, each
        lane drawing from its own request's seed."""
        preps = [self._prep(g.payload) for g in group]
        ids_list = [pr[0] for pr in preps]
        feats_list = ([pr[1] for pr in preps]
                      if preps[0][1] is not None else None)
        _, _, sp, max_new, _ = preps[0]
        t0 = time.time()
        seeds = [int(g.payload.get("seed", 0)) for g in group]
        rs = self.adapter.gen.generate_batch(ids_list, feats_list,
                                             max_new_tokens=max_new, sp=sp,
                                             seeds=seeds)
        dt = time.time() - t0
        self.batches += 1
        for g, r in zip(group, rs):
            g.result = self._decode_result(r.tokens, dt, r)
            g.result["batch_size"] = len(group)
            self.served += 1
            g.done.set()

    def _handle_stream(self, w):
        ids, feats, sp, max_new, use_msd = self._prep(w.payload)
        gen = self.adapter.gen
        seed = int(w.payload.get("seed", 0))
        t0 = time.time()
        n = 0
        if use_msd:
            for chunk in gen.generate_stream(ids, img_feats=feats,
                                             max_new_tokens=max_new, sp=sp,
                                             seed=seed,
                                             segment=int(w.payload.get(
                                                 "segment", 16))):
                n += len(chunk)
                w.chunks.put(self.adapter.tokenizer.decode(
                    list(chunk), skip_special_tokens=True))
        else:  # the AR baseline has no segments: one chunk
            r = gen.naive_generate(ids, img_feats=feats,
                                   max_new_tokens=max_new, sp=sp, seed=seed)
            n = len(r.tokens)
            w.chunks.put(self.adapter.tokenizer.decode(
                list(r.tokens), skip_special_tokens=True))
        dt = time.time() - t0
        w.result = {"done": True, "tokens_generated": n, "seconds": dt,
                    "tokens_per_second": n / max(dt, 1e-9)}
        w.chunks.put(None)
        w.done.set()


class ContinuousWorker(EngineWorker):
    """EngineWorker variant backed by a ContinuousScheduler: compatible
    requests JOIN the running slot batch at the next segment boundary
    (continuous batching) instead of waiting for the current batch to
    drain.

    Compatible = sampling parameters match the scheduler's and MSD is on;
    image and text prompts mix freely. Incompatible requests run through
    the single-request path, but only while the scheduler is idle: under
    sustained compatible load they wait (slots never stall on a foreign
    request).
    """

    def __init__(self, adapter, n_slots: int = 4, segment: int = 16):
        super().__init__(adapter)
        from msd_tpu_torch.serve.continuous import ContinuousScheduler
        self.sched = ContinuousScheduler(adapter.gen, n_slots=n_slots,
                                         segment=segment)
        self._serial = deque()

    def _compatible(self, p) -> bool:
        sp = self.sched.sp
        return (float(p.get("temperature", 0.0)) == sp.temperature
                and float(p.get("top_p", 1.0)) == sp.top_p
                and bool(p.get("use_msd", True)) and self.adapter.use_msd)

    def _dispatch(self, w: Optional[_Work]):
        if w is None:
            return
        if not self._compatible(w.payload):
            self._serial.append(w)
            return
        from msd_tpu_torch.serve.continuous import Request
        try:
            ids, feats, _, max_new, _ = self._prep(w.payload)
        except Exception as e:
            w.fail(f"{type(e).__name__}: {e}")
            return
        req = Request(ids=ids, img_feats=feats, max_new=max_new,
                      seed=int(w.payload.get("seed", 0)))
        req._work = w
        req._t0 = time.time()
        if w.stream:
            tok = self.adapter.tokenizer
            req.on_tokens = lambda t: w.chunks.put(
                tok.decode(list(t), skip_special_tokens=True))
        self.sched.submit(req)

    def _finish(self, req):
        w = req._work
        if req.error is not None:        # solo admission failure
            w.fail(req.error)
            return
        dt = time.time() - req._t0
        self.served += 1
        if w.stream:
            w.result = {"done": True, "tokens_generated": len(req.tokens),
                        "seconds": dt,
                        "tokens_per_second": len(req.tokens) / max(dt, 1e-9),
                        "avg_accept_len": req.avg_accept_len}
            w.chunks.put(None)
        else:
            w.result = self._decode_result(req.tokens, dt, req)
            w.result["segments"] = req.segments
        w.done.set()

    def _fail_all(self, err: str):
        works = [a.req._work for a in self.sched.slots if a is not None]
        works += [r._work for r in self.sched.queue]
        self.sched.slots = [None] * self.sched.n_slots
        self.sched.queue.clear()
        for w in works:
            w.fail(err)

    def run(self):
        while not self._stop_event.is_set():
            block = not (self.sched.busy or self._serial)
            try:
                self._dispatch(self.q.get(block=block))
                while True:
                    self._dispatch(self.q.get_nowait())
            except queue.Empty:
                pass
            if self.sched.busy:
                try:
                    finished = self.sched.step()
                    self.batches += 1
                except Exception as e:  # surfaced to every in-flight client
                    self._fail_all(f"{type(e).__name__}: {e}")
                    finished = []
                for req in finished:
                    self._finish(req)
            elif self._serial:
                w = self._serial.popleft()
                try:
                    if w.stream:
                        self._handle_stream(w)
                    else:
                        w.result = self._handle(w.payload)
                        w.done.set()
                    self.served += 1
                except Exception as e:
                    w.fail(f"{type(e).__name__}: {e}")


def make_handler(worker: EngineWorker):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *a):
            pass

        def _send(self, code, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/health":
                info = {"status": "ok", "served": worker.served,
                        "batches": worker.batches,
                        "queued": worker.q.qsize()}
                sched = getattr(worker, "sched", None)
                if sched is not None:
                    info["active_slots"] = sched.active
                    info["n_slots"] = sched.n_slots
                    info["segments_run"] = sched.steps
                self._send(200, info)
            else:
                self._send(404, {"error": "unknown path"})

        def _read_payload(self):
            n = int(self.headers.get("Content-Length", 0))
            return json.loads(self.rfile.read(n) or b"{}")

        def do_POST(self):
            try:
                if self.path == "/generate":
                    payload = self._read_payload()
                    if "prompt" not in payload:
                        self._send(400, {"error": "missing 'prompt'"})
                        return
                    w = _Work(payload)
                    worker.q.put(w)
                    w.done.wait()
                    if w.error:
                        self._send(500, {"error": w.error})
                    else:
                        self._send(200, w.result)
                elif self.path == "/generate_stream":
                    payload = self._read_payload()
                    if "prompt" not in payload:
                        self._send(400, {"error": "missing 'prompt'"})
                        return
                    w = _Work(payload, stream=True)
                    worker.q.put(w)
                    self.send_response(200)
                    self.send_header("Content-Type", "application/jsonl")
                    self.send_header("Transfer-Encoding", "chunked")
                    self.end_headers()

                    def emit(obj):
                        line = (json.dumps(obj) + "\n").encode()
                        self.wfile.write(f"{len(line):x}\r\n".encode()
                                         + line + b"\r\n")

                    while True:
                        chunk = w.chunks.get()
                        if chunk is None:
                            break
                        emit({"text": chunk})
                    if w.error:
                        emit({"error": w.error})
                    elif w.result:
                        emit(w.result)
                    self.wfile.write(b"0\r\n\r\n")
                else:
                    self._send(404, {"error": "unknown path"})
            except Exception as e:
                try:
                    self._send(500, {"error": str(e)})
                except Exception:
                    pass

    return Handler


def serve_forever(adapter, port: int = 8399, host: str = "127.0.0.1",
                  continuous: int = 0, segment: int = 16):
    """Start the worker and return the HTTP server (the caller runs its
    ``serve_forever()``, on a thread of its own if it likes; ``port=0``
    binds a free port, ``server.server_address`` says which). The worker
    is ``server.worker``; ``shutdown(server)`` stops both.
    continuous=N serves through an N-slot continuous batcher
    (ContinuousWorker); 0 keeps the micro-batching worker."""
    worker = (ContinuousWorker(adapter, n_slots=continuous, segment=segment)
              if continuous > 0 else EngineWorker(adapter))
    worker.start()
    httpd = ThreadingHTTPServer((host, port), make_handler(worker))
    httpd.daemon_threads = True
    httpd.worker = worker
    return httpd


def shutdown(httpd) -> None:
    """Stop a server made by ``serve_forever``: its request loop (if one
    runs), its socket and its worker thread."""
    # socketserver's shutdown() waits for a running serve_forever() and
    # forever when none runs: wait on a thread of its own, boundedly
    stopper = threading.Thread(target=httpd.shutdown, daemon=True)
    stopper.start()
    stopper.join(timeout=30)
    httpd.server_close()
    httpd.worker.stop()
    httpd.worker.join(timeout=60)


def parse_args(argv=None):
    import argparse

    ap = argparse.ArgumentParser("msd_tpu_torch.serve")
    ap.add_argument("--pretrained", required=True)
    ap.add_argument("--msd_model_path", required=True)
    ap.add_argument("--port", type=int, default=8399)
    ap.add_argument("--no-msd", dest="use_msd", action="store_false")
    ap.add_argument("--max-seq-len", type=int, default=None,
                    help="allocated KV length per request")
    ap.add_argument("--continuous", type=int, default=0, metavar="N",
                    help="continuous batching over N slots (0 = static "
                         "micro-batching); each slot owns a full KV "
                         "allocation: size N to the free device memory")
    ap.add_argument("--segment", type=int, default=16,
                    help="tokens per scheduling segment in continuous mode")
    ap.add_argument("--device", default="cuda",
                    help="weights in bf16 on a CUDA device, else fp32")
    return ap.parse_args(argv)


def server_from_args(args):
    """The server ``main`` runs: the checkpoint's adapter
    (``LlavaMSD.from_pretrained``) behind ``serve_forever``; the caller
    runs its ``serve_forever()``."""
    from msd_tpu_torch.harness.models.llava_msd import LlavaMSD

    kw = {"max_seq_len": args.max_seq_len} if args.max_seq_len else {}
    adapter = LlavaMSD.from_pretrained(
        args.pretrained, args.msd_model_path, device=args.device,
        use_msd=args.use_msd, **kw)
    return serve_forever(adapter, args.port, continuous=args.continuous,
                         segment=args.segment)


def main(argv=None):
    httpd = server_from_args(parse_args(argv))
    print(f"serving on :{httpd.server_address[1]}", flush=True)
    httpd.serve_forever()


if __name__ == "__main__":
    main()
