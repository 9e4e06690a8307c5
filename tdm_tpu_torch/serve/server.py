"""HTTP serving front end over the micro-batcher — the port's `tdm-serve`.

Port of `tdm_tpu/serve/server.py` (stdlib `http.server`, JSON API):

    python -m tdm_tpu_torch.serve.server --model out/pixart_tdm \\
        --batch_size 4 --port 8000 [--device cpu]   (raw prompts through the
                                       bundled T5 and tokenizer)
    python -m tdm_tpu_torch.serve.server --model out/pixart_tdm \\
        --embedding_cache cache.npz   (no encoder attached: cached prompts)
    python -m tdm_tpu_torch.serve.server --model out/sd3 --lora tdm.safetensors \\
        --lora_scale 0.125 --embedding_cache sd3_cache.npz   (SD3, 1024²)
    python -m tdm_tpu_torch.serve.server --model PixArt-alpha/PixArt-XL-2-512x512 \\
        --embedding_cache cache.npz   (a diffusers checkout, or its repo id
                                       in the local hub cache)
    python -m tdm_tpu_torch.serve.server --model dreamshaper-7 --lora tdm.safetensors \\
        --embedding_cache clip_cache.npz   (SD1.5, 512², a CLIP-L cache)
    python -m tdm_tpu_torch.serve.server --model CogVideoX-2b --lora tdm.safetensors \\
        --embedding_cache t5_cache.npz --num_frames 49   (CogVideoX, 480×720,
                                       a T5 cache of [226, 4096] rows)
    python -m tdm_tpu_torch.serve.server --model out/sd3 --quant int8 ...
                                      (int8 products in the sampler)
    python -m tdm_tpu_torch.serve.server --model out/pixart_tdm --dp 4 \
        --batch_size 8   (a replica on each of 4 local GPUs; each batch's
                          rows split 2 per GPU, `pipelines/base.py`)
    python -m tdm_tpu_torch.serve.server --model out/pixart_tdm --tp 2
                         (Megatron tensor parallelism over cuda:0 and cuda:1,
                          `parallel/tp.py`: this process answers HTTP and
                          starts the follower process itself; with
                          --device cuda:0 both ranks share that card over
                          gloo; under torchrun or TDM_* it joins that world)

    POST /generate   {"prompt": "...", "seed": 8888, "negative_prompt": "..."}
                     → {"image": <base64 PNG>, "format": "png",
                        "shape": [H, W, 3], "seed": 8888}
                     (a video: {"video": <base64 GIF>, "format": "gif",
                        "shape": [F, H, W, 3], "seed": 8888})
    GET  /healthz    → {"ok": true, "stats": {...}}
    GET  /stats      → the same batching counters
    GET  /metrics    → the counters in Prometheus text exposition

PNGs are encoded with the standard library's zlib and GIFs by `encode_gif`
(no imaging package).
"""

from __future__ import annotations

import argparse
import base64
import io
import json
import struct
import sys
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


# the GIF's fixed palette: a 6×7×6 colour cube (252 colours, green finest),
# so a GIF's bytes depend on its frames alone
GIF_LEVELS = (6, 7, 6)
GIF_DELAY_MS = 125  # 8 fps, the reference's export_to_video rate


def gif_palette() -> np.ndarray:
    """[256, 3] uint8: the colour cube in index order (r, g, b), padded with
    black to the 256 entries of an 8-bit colour table."""
    r, g, b = (np.round(np.arange(n) * 255.0 / (n - 1)) for n in GIF_LEVELS)
    cube = np.stack(np.meshgrid(r, g, b, indexing="ij"), axis=-1).reshape(-1, 3)
    return np.concatenate([cube, np.zeros((256 - len(cube), 3))]).astype(np.uint8)


def gif_indices(frames: np.ndarray) -> np.ndarray:
    """[F, H, W, 3] float in [0, 1] → [F, H, W] uint8 palette indices: each
    channel rounded to its nearest cube level (within half a level step)."""
    lv = np.array(GIF_LEVELS)
    q = np.rint(np.clip(frames, 0.0, 1.0) * (lv - 1)).astype(np.uint8)
    return (q[..., 0] * (lv[1] * lv[2]) + q[..., 1] * lv[2] + q[..., 2]).astype(np.uint8)


def _lzw(indices: bytes) -> bytes:
    """GIF's variable-width LZW of a frame's palette indices: a clear code
    first and again whenever the table fills (next code 4095), the end code
    last; the m-th code after a clear is 9 + [m ≥ 255] + [m ≥ 767] + [m ≥
    1791] bits wide (the width grows when the next code reaches 512, 1024,
    2048), packed low bit first. The indices are 8-bit: the minimum code
    size is 8."""
    min_size = 8
    clear, end = 1 << min_size, (1 << min_size) + 1
    codes, clears = [clear], [0]
    table: dict = {}
    get, append = table.get, codes.append
    next_code = end + 1
    prefix = indices[0]
    for k in indices[1:]:
        key = (prefix << 8) | k
        code = get(key)
        if code is not None:
            prefix = code
            continue
        append(prefix)
        if next_code == 4095:
            clears.append(len(codes))
            append(clear)
            table.clear()
            next_code = end + 1
        else:
            table[key] = next_code
            next_code += 1
        prefix = k
    append(prefix)
    append(end)
    codes = np.array(codes, np.int64)
    pos = np.arange(len(codes))
    starts = np.array(clears)
    m = pos - starts[np.maximum(np.searchsorted(starts, pos, side="left") - 1, 0)] - 1
    sizes = min_size + 1 + (m >= 255) + (m >= 767) + (m >= 1791)
    sizes[0] = min_size + 1
    bits = (codes[:, None] >> np.arange(12)) & 1
    return np.packbits(bits[np.arange(12) < sizes[:, None]].astype(np.uint8),
                       bitorder="little").tobytes()


def encode_gif(frames: np.ndarray, *, delay_ms: int = GIF_DELAY_MS) -> bytes:
    """[F, H, W, 3] float in [0, 1] → GIF89a bytes: the fixed colour cube as
    the global colour table, the NETSCAPE2.0 block looping forever, and per
    frame a graphic control block (the delay in centiseconds, truncated as
    Pillow writes it: 125 ms → 12) and the LZW-coded indices in sub-blocks
    of at most 255 bytes."""
    if frames.ndim != 4 or frames.shape[-1] != 3:
        raise ValueError(f"encode_gif takes [F, H, W, 3] frames, got {frames.shape}")
    n, h, w, _ = frames.shape
    idx = gif_indices(frames)
    parts = [b"GIF89a", struct.pack("<HHBBB", w, h, 0xF7, 0, 0), gif_palette().tobytes(),
             b"\x21\xff\x0bNETSCAPE2.0\x03\x01" + struct.pack("<H", 0) + b"\x00"]
    for i in range(n):
        parts.append(b"\x21\xf9\x04\x04" + struct.pack("<H", delay_ms // 10) + b"\x00\x00")
        parts.append(b"\x2c" + struct.pack("<HHHHB", 0, 0, w, h, 0) + b"\x08")
        data = _lzw(idx[i].tobytes())
        parts.extend(bytes([len(data[j:j + 255])]) + data[j:j + 255]
                     for j in range(0, len(data), 255))
        parts.append(b"\x00")
    parts.append(b"\x3b")
    return b"".join(parts)


def _encode_image(arr: np.ndarray) -> dict:
    """[H,W,3] float in [0,1] → PNG; [F,H,W,3] → GIF (`encode_gif`, 8 fps);
    anything else (a pipeline with no VAE returns raw latents) → base64
    .npy."""
    arr = np.asarray(arr, np.float32)
    if arr.ndim == 4 and arr.shape[-1] == 3:
        return {
            "video": base64.b64encode(encode_gif(arr)).decode(),
            "format": "gif",
            "shape": list(arr.shape),
        }
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
        tp_world=None,
    ):
        self.batcher = batcher
        self.tp_world = tp_world  # rank 0's tensor-parallel world (parallel/tp.TPWorld)
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
        if self.tp_world is not None:
            self.tp_world.stop()


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
    p.add_argument("--num_frames", type=int, default=None,
                   help="video frames (CogVideoX; the pipeline's default 49)")
    p.add_argument("--flow_shift", type=float, default=None,
                   help="the flow grid's shift (SD3; the pipeline's default 6)")
    p.add_argument("--lora", default=None,
                   help="kohya or peft LoRA safetensors merged into the denoiser")
    p.add_argument("--lora_scale", type=float, default=1.0,
                   help="its adapter scale (the SD3 recipe: 0.125)")
    p.add_argument("--embedding_cache", default=None,
                   help="offline text embedding cache (.npz from cli/build_cache; "
                        "SD3 needs its pooled vectors) when the pipeline has no "
                        "text encoders attached")
    p.add_argument("--compilation_cache", default="auto",
                   help="the JAX package's XLA compile cache; accepted and "
                        "ignored (the port compiles nothing ahead of time)")
    p.add_argument("--max_queue", type=int, default=64,
                   help="max pending requests; a full queue answers HTTP 429")
    p.add_argument("--batch_buckets", default=None,
                   help="comma-separated batch sizes a partial batch rounds "
                        "up to, e.g. '1,4'")
    p.add_argument("--readback_dtype", default=None, choices=(None, "bfloat16", "float16"),
                   help="cast results on the device before the host copy")
    p.add_argument("--warmup", nargs="?", const="", default=None, metavar="PROMPT",
                   help="run one discarded batch per bucket before accepting "
                        "traffic; with no PROMPT uses '' (or the first cached "
                        "prompt when serving from --embedding_cache)")
    p.add_argument("--quant", default=None, choices=(None, "int8"),
                   help="dynamic int8 products for the denoiser's large linear "
                        "layers in the sampler (ops/quant.py)")
    p.add_argument("--dp", type=int, default=0,
                   help="data-parallel replicas, one per local GPU (cuda:0..N-1; N "
                        "replicas on the CPU under --device cpu): each batch's rows "
                        "split N ways; --batch_size and every bucket must be multiples")
    p.add_argument("--tp", type=int, default=0,
                   help="tensor-parallel serving over N processes, one per local GPU "
                        "(cuda:0..N-1; every rank on the named card under --device "
                        "cuda:K, or on the CPU under --device cpu)")
    args = p.parse_args(argv)
    args.argv = list(sys.argv[1:] if argv is None else argv)  # the followers' command
    return args


def build_server(args: argparse.Namespace) -> TDMServer:
    """Load the pipeline, make the batcher and bind the socket (before the
    warm-up, so early clients wait in the listen backlog). Under --tp N this
    process is rank 0: it starts the followers once its pipeline is loaded
    (`parallel/tp.launch`), and the server's close stops them."""
    if args.tp and args.dp:
        raise SystemExit("--tp and --dp are mutually exclusive")
    dp_devices = _dp_devices(args) if args.dp and args.dp > 1 else None
    n_tp = args.tp if args.tp and args.tp > 1 else 1
    from tdm_tpu_torch.device import resolve_device
    from tdm_tpu_torch.parallel import tp as tp_lib
    from tdm_tpu_torch.serve.batcher import MicroBatcher

    if n_tp > 1:
        tp_lib.check_devices(n_tp, resolve_device(args.device))
    pipe = _load(args, args.device)
    world = None
    if n_tp > 1:
        world = tp_lib.launch("tdm_tpu_torch.serve.server", args.argv, n_tp,
                              resolve_device(args.device))
        pipe.tensor_parallel = world.tp
    if dp_devices is not None:
        pipe.data_parallel_devices = dp_devices
    call = {"num_inference_steps": args.num_inference_steps,
            "guidance_scale": args.guidance_scale}
    for k in ("height", "width", "num_frames", "flow_shift"):
        if getattr(args, k) is not None:
            call[k] = getattr(args, k)
    if "flow_shift" in call and pipe.family != "sd3":
        raise ValueError(f"--flow_shift applies to the flow models (sd3), not {pipe.family}")
    if "num_frames" in call and pipe.family != "cogvideox":
        raise ValueError(f"--num_frames applies to the video model (cogvideox), not "
                         f"{pipe.family}")
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
    server = TDMServer(batcher, args.host, args.port, tp_world=world)
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


def _load(args: argparse.Namespace, device, *, denoiser_only: bool = False):
    """The served pipeline (a tp follower's: the denoiser alone) with the
    LoRA merged at its scale and the int8 route set."""
    from tdm_tpu_torch.device import set_fp32_precision
    from tdm_tpu_torch.pipelines import from_pretrained

    set_fp32_precision()  # the decoders' fp32 convolutions in full fp32, as in JAX
    pipe = from_pretrained(args.model, device=device, denoiser_only=denoiser_only)
    if args.lora:
        pipe.load_lora_weights(args.lora, adapter_name="tdm")
        pipe.set_adapters(["tdm"], [args.lora_scale])
    if args.quant:
        pipe.quant = args.quant
    return pipe


def _dp_devices(args: argparse.Namespace) -> list:
    """The --dp devices, checked before any model loads (the JAX server's
    rules, `tdm_tpu/serve/server.py:334-362`): --batch_size and every
    --batch_buckets entry multiples of N; on CUDA, cuda:0..N-1, all of which must exist (no smaller mesh);
    under --device cpu, N replicas on the CPU."""
    import torch

    from tdm_tpu_torch.device import resolve_device

    if args.batch_size % args.dp:
        raise SystemExit(
            f"--batch_size {args.batch_size} must be a multiple of "
            f"--dp {args.dp} (the batch shards over the mesh)"
        )
    if args.batch_buckets and any(int(b) % args.dp for b in args.batch_buckets.split(",")):
        raise SystemExit(
            f"--batch_buckets {args.batch_buckets} must all be multiples "
            f"of --dp {args.dp} (each bucket batch shards over the mesh)"
        )
    device = resolve_device(args.device)
    if device.type != "cuda":
        return [device] * args.dp
    count = torch.cuda.device_count()
    if args.dp > count:
        raise ValueError(f"--dp {args.dp} needs {args.dp} CUDA devices; {count} visible")
    return [torch.device("cuda", i) for i in range(args.dp)]


def main(argv=None) -> None:
    args = parse_args(argv)
    if args.tp and args.tp > 1 and not args.dp:
        from tdm_tpu_torch.parallel import tp as tp_lib

        if tp_lib.is_follower():  # a rank of a --tp world: no HTTP, rank 0's calls
            from tdm_tpu_torch.device import resolve_device

            tp_lib.run_follower(args.tp, resolve_device(args.device),
                                lambda dev: _load(args, dev, denoiser_only=True))
            return
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
