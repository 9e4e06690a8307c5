"""HTTP serving front end over the micro-batcher — the port's `tdm-serve`.

Port of `tdm_tpu/serve/server.py` (stdlib `http.server`, JSON API):

    python -m tdm_tpu_torch.serve.server --model out/pixart_tdm \\
        --embedding_cache cache.npz --batch_size 4 --port 8000 [--device cpu]
    python -m tdm_tpu_torch.serve.server --model out/sd3 --lora tdm.safetensors \\
        --lora_scale 0.125 --embedding_cache sd3_cache.npz   (SD3, 1024²)
    python -m tdm_tpu_torch.serve.server --model PixArt-alpha/PixArt-XL-2-512x512 \\
        --embedding_cache cache.npz   (a diffusers checkout, or its repo id
                                       in the local hub cache)
    python -m tdm_tpu_torch.serve.server --model dreamshaper-7 --lora tdm.safetensors \\
        --embedding_cache clip_cache.npz   (SD1.5, 512², a CLIP-L cache)

    POST /generate   {"prompt": "...", "seed": 8888, "negative_prompt": "..."}
                     → {"image": <base64 PNG>, "format": "png",
                        "shape": [H, W, 3], "seed": 8888}
    GET  /healthz    → {"ok": true, "stats": {...}}
    GET  /stats      → the same batching counters
    GET  /metrics    → the counters in Prometheus text exposition

PNGs are encoded with the standard library's zlib (no imaging package).
"""

from __future__ import annotations

import argparse
import base64
import io
import json
import struct
import threading
import time
import zlib
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np


def _prometheus_metrics(stats: dict) -> str:
    """ServeStats → Prometheus text exposition."""
    counters = {
        "requests": "generation requests accepted",
        "batches": "batch dispatches",
        "rows_padded": "padded (wasted) batch rows",
        "failures": "requests failed in the worker",
        "rejected": "requests rejected with 429 (queue full)",
    }
    gauges = {
        "last_batch_latency_s": "dispatch to readback-complete of the last batch",
        "last_batch_period_s": "completion-to-completion interval of the last batch",
        "mean_fill": "mean requests per dispatched batch",
    }
    lines = []
    for name, help_ in counters.items():
        lines += [
            f"# HELP tdm_serve_{name}_total {help_}",
            f"# TYPE tdm_serve_{name}_total counter",
            f"tdm_serve_{name}_total {stats.get(name, 0)}",
        ]
    for name, help_ in gauges.items():
        lines += [
            f"# HELP tdm_serve_{name} {help_}",
            f"# TYPE tdm_serve_{name} gauge",
            f"tdm_serve_{name} {stats.get(name, 0.0)}",
        ]
    lines += [
        "# HELP tdm_serve_batches_by_shape_total batches per batch size",
        "# TYPE tdm_serve_batches_by_shape_total counter",
    ]
    for shape, count in stats.get("batches_by_shape", {}).items():
        lines.append(f'tdm_serve_batches_by_shape_total{{shape="{shape}"}} {count}')
    return "\n".join(lines) + "\n"


def encode_png(rgb: np.ndarray) -> bytes:
    """[H, W, 3] uint8 → PNG bytes: 8-bit RGB, filter 0 on every row,
    one zlib-compressed IDAT chunk."""
    h, w, c = rgb.shape
    if c != 3 or rgb.dtype != np.uint8:
        raise ValueError(f"encode_png takes [H, W, 3] uint8, got {rgb.shape} {rgb.dtype}")
    rows = np.concatenate([np.zeros((h, 1), np.uint8), rgb.reshape(h, w * 3)], axis=1)

    def chunk(tag: bytes, data: bytes) -> bytes:
        crc = zlib.crc32(tag + data) & 0xFFFFFFFF
        return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", crc)

    return (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
        + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
        + chunk(b"IEND", b"")
    )


def _encode_image(arr: np.ndarray) -> dict:
    """[H,W,3] float in [0,1] → PNG; anything else (a pipeline with no VAE
    returns raw latents) → base64 .npy."""
    arr = np.asarray(arr, np.float32)
    if not (arr.ndim == 3 and arr.shape[-1] == 3):
        buf = io.BytesIO()
        np.save(buf, arr)
        return {
            "latents": base64.b64encode(buf.getvalue()).decode(),
            "format": "npy",
            "shape": list(arr.shape),
        }
    png = encode_png((np.clip(arr, 0.0, 1.0) * 255).astype(np.uint8))
    return {
        "image": base64.b64encode(png).decode(),
        "format": "png",
        "shape": list(arr.shape),
    }


def make_handler(batcher, request_timeout_s: float = 600.0):
    from tdm_tpu_torch.serve.batcher import Overloaded

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            pass  # quiet; the batcher keeps the counters

        def _json(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            if code == 429:
                s = batcher.stats
                period = (
                    min(s.last_batch_latency_s, s.last_batch_period_s)
                    if s.last_batch_period_s > 0
                    else s.last_batch_latency_s
                )
                self.send_header("Retry-After", str(max(1, int(period + 0.5))))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path in ("/healthz", "/stats"):
                self._json(200, {"ok": True, "stats": batcher.stats.as_dict()})
            elif self.path == "/metrics":
                body = _prometheus_metrics(batcher.stats.as_dict()).encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self._json(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            if self.path != "/generate":
                self._json(404, {"error": f"unknown path {self.path}"})
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
                req = json.loads(self.rfile.read(length) or b"{}")
                prompt = req.get("prompt")
                if not prompt:
                    self._json(400, {"error": "missing 'prompt'"})
                    return
                seed = int(req.get("seed", 0))
                fut = batcher.submit(
                    prompt, negative_prompt=req.get("negative_prompt"), seed=seed
                )
                out = _encode_image(fut.result(timeout=request_timeout_s))
                out["seed"] = seed
            except Overloaded as e:
                self._json(429, {"error": str(e), "retry": True})
                return
            except KeyError as e:
                self._json(400, {"error": str(e)})
                return
            except (BrokenPipeError, ConnectionResetError):
                return  # the client went away mid-read
            except Exception as e:  # keep the daemon alive on a bad request
                self._json(500, {"error": f"{type(e).__name__}: {e}"})
                return
            try:
                # the success write stays outside the catch-all: a disconnect
                # mid-write must not send a second status line
                self._json(200, out)
            except (BrokenPipeError, ConnectionResetError):
                pass

    return Handler


class TDMServer:
    """The HTTP server and its batcher; `start()` runs the accept loop on a
    daemon thread, `serve_forever()` blocks."""

    def __init__(
        self,
        batcher,
        host: str = "127.0.0.1",
        port: int = 8000,
        *,
        request_timeout_s: float = 600.0,
    ):
        self.batcher = batcher
        self.httpd = ThreadingHTTPServer((host, port), make_handler(batcher, request_timeout_s))
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    def start(self) -> "TDMServer":
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, name="tdm-serve-http", daemon=True
        )
        self._thread.start()
        return self

    def serve_forever(self) -> None:
        self.httpd.serve_forever()

    def close(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
        self.batcher.close()


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model", required=True,
                   help="tdm_tpu-layout pipeline dir, diffusers checkout dir, or "
                        "'org/name' repo id in the local HF hub cache")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; 'cpu' to run on the CPU)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--max_delay_ms", type=float, default=50.0,
                   help="collect window after the first queued request")
    p.add_argument("--num_inference_steps", type=int, default=4)
    p.add_argument("--guidance_scale", type=float, default=1.0)
    p.add_argument("--negative_prompt", default=None,
                   help="server-wide negative prompt (CFG > 1 only)")
    p.add_argument("--height", type=int, default=None)
    p.add_argument("--width", type=int, default=None)
    p.add_argument("--flow_shift", type=float, default=None,
                   help="the flow grid's shift (SD3; the pipeline's default 6)")
    p.add_argument("--lora", default=None,
                   help="kohya or peft LoRA safetensors merged into the denoiser")
    p.add_argument("--lora_scale", type=float, default=1.0,
                   help="its adapter scale (the SD3 recipe: 0.125)")
    p.add_argument("--embedding_cache", default=None,
                   help="offline text embedding cache (.npz from cli/build_cache; "
                        "SD3 needs its pooled vectors)")
    p.add_argument("--max_queue", type=int, default=64,
                   help="max pending requests; a full queue answers HTTP 429")
    p.add_argument("--batch_buckets", default=None,
                   help="comma-separated batch sizes a partial batch rounds "
                        "up to, e.g. '1,4'")
    p.add_argument("--readback_dtype", default=None, choices=(None, "bfloat16", "float16"),
                   help="cast results on the device before the host copy")
    p.add_argument("--warmup", nargs="?", const="", default=None, metavar="PROMPT",
                   help="run one discarded batch per bucket before accepting "
                        "traffic; with no PROMPT uses the first cached prompt")
    # options of the JAX server whose modules are not ported yet
    p.add_argument("--quant", default=None, choices=(None, "int8"),
                   help="not ported yet (ROADMAP slice 4)")
    p.add_argument("--tp", type=int, default=0, help="not ported yet (ROADMAP slice 6)")
    p.add_argument("--dp", type=int, default=0, help="not ported yet (ROADMAP slice 6)")
    return p.parse_args(argv)


def build_server(args: argparse.Namespace) -> TDMServer:
    """Load the pipeline, make the batcher and bind the socket (before the
    warm-up, so early clients wait in the listen backlog)."""
    for flag, value, where in (
        ("--quant", args.quant, "slice 4 (int8)"),
        ("--tp", args.tp > 1, "slice 6 (multi-GPU)"),
        ("--dp", args.dp > 1, "slice 6 (multi-GPU)"),
    ):
        if value:
            raise NotImplementedError(
                f"{flag} is not ported yet: ROADMAP.md queue 1, {where}"
            )
    from tdm_tpu_torch.pipelines import from_pretrained
    from tdm_tpu_torch.serve.batcher import MicroBatcher

    pipe = from_pretrained(args.model, device=args.device)
    if args.lora:
        pipe.load_lora_weights(args.lora, adapter_name="tdm")
        pipe.set_adapters(["tdm"], [args.lora_scale])
    call = {"num_inference_steps": args.num_inference_steps,
            "guidance_scale": args.guidance_scale}
    for k in ("height", "width", "flow_shift"):
        if getattr(args, k) is not None:
            call[k] = getattr(args, k)
    if "flow_shift" in call and pipe.family != "sd3":
        raise ValueError(f"--flow_shift applies to the flow models (sd3), not {pipe.family}")
    buckets = None
    if args.batch_buckets:
        buckets = tuple(int(b) for b in args.batch_buckets.split(","))
    batcher = MicroBatcher(
        pipe,
        batch_size=args.batch_size,
        max_delay_ms=args.max_delay_ms,
        call_kwargs=call,
        embedding_cache=args.embedding_cache,
        negative_prompt=args.negative_prompt,
        max_queue=args.max_queue,
        batch_buckets=buckets,
        readback_dtype=args.readback_dtype,
    )
    server = TDMServer(batcher, args.host, args.port)
    if args.warmup is not None:
        wp = args.warmup
        if not wp and args.embedding_cache:
            from tdm_tpu_torch.data.prompts import EmbeddingCache

            wp = EmbeddingCache.load(args.embedding_cache).prompts[0]
        t0 = time.monotonic()
        batcher.warm(wp)
        print(f"tdm-serve: warmed {len(batcher.batch_buckets)} batch shape(s) "
              f"in {time.monotonic() - t0:.1f}s", flush=True)
    return server


def main(argv=None) -> None:
    args = parse_args(argv)
    server = build_server(args)
    print(f"tdm-serve: {type(server.batcher.pipe).__name__} on "
          f"{server.batcher.device} at http://{args.host}:{server.port} "
          f"(batch {args.batch_size}, window {args.max_delay_ms}ms)", flush=True)
    # SIGTERM takes the same graceful path as Ctrl-C
    import signal

    def _term(signum, frame):
        raise KeyboardInterrupt

    try:
        prev = signal.signal(signal.SIGTERM, _term)
    except ValueError:  # embedded caller off the main thread: no handler
        prev = None
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.close()
    finally:
        if prev is not None:
            signal.signal(signal.SIGTERM, prev)


if __name__ == "__main__":
    main()
