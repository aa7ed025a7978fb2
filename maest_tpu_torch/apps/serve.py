"""HTTP tagging server on the PyTorch serving stack, port of
``maest_tpu/apps/serve.py``.

Puts ``maest_tpu_torch.serve.TagService`` behind three endpoints:

    POST /tag      raw little-endian float32 16 kHz mono PCM
                   (Content-Type: application/octet-stream); 16-bit PCM of
                   native length as Content-Type: audio/l16 (BIG-endian,
                   RFC 2586/3555) or audio/pcm (little-endian s16le), decoded
                   on the device; or JSON {"waveform": [...]}
                   -> {"labels": [[name, score]...]}
    GET  /healthz  liveness probe
    GET  /stats    batching / latency counters (JSON)

Run:
    python -m maest_tpu_torch.apps.serve [--arch ...] [--port 8321]
        [--no-pretrained] [--checkpoint FILE] [--device cuda]
        [--dtype bfloat16|float32] [--max-wait-ms 5] [--top-k 10]
        [--buckets 1,2,4,8,16,32]
"""

from __future__ import annotations

import argparse
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

_DTYPES = ("bfloat16", "float32")


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="maest-serve-torch",
        description="MAEST tagging server (PyTorch/CUDA)")
    ap.add_argument("--arch", default="discogs-maest-30s-pw-129e")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8321)
    ap.add_argument("--top-k", type=int, default=10)
    ap.add_argument("--max-wait-ms", type=float, default=5.0,
                    help="co-batching linger before dispatch")
    ap.add_argument("--buckets", default="1,2,4,8,16,32",
                    help="comma-separated batch buckets")
    ap.add_argument("--no-pretrained", dest="pretrained",
                    action="store_false", default=True)
    ap.add_argument("--device", default="cuda",
                    help="torch device the model runs on")
    ap.add_argument("--no-warmup", dest="warmup", action="store_false",
                    default=True, help="skip running every bucket at start")
    ap.add_argument("--dtype", default="bfloat16", choices=_DTYPES,
                    help="compute dtype (bf16 is the production path)")
    # tiny-geometry overrides (tests / CPU smoke)
    ap.add_argument("--embed-dim", type=int, default=768)
    ap.add_argument("--depth", type=int, default=12)
    ap.add_argument("--num-heads", type=int, default=12)
    ap.add_argument("--input-t", type=int, default=None)
    ap.add_argument("--n-classes", type=int, default=None)
    return ap


def make_service(args):
    import torch

    from ..api import get_maest
    from ..serve import TagService

    model = get_maest(
        arch=args.arch, pretrained=args.pretrained,
        checkpoint=args.checkpoint, dtype=getattr(torch, args.dtype),
        device=args.device, embed_dim=args.embed_dim, depth=args.depth,
        num_heads=args.num_heads, input_t=args.input_t,
        n_classes=args.n_classes,
    )
    buckets = tuple(int(b) for b in args.buckets.split(","))
    return TagService(model, buckets=buckets, max_wait_ms=args.max_wait_ms,
                      warmup=args.warmup, warmup_pcm16=args.warmup)


def make_handler(service, top_k: int):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet by default
            pass

        def _json(self, code: int, obj) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {"ok": True})
            elif self.path == "/stats":
                self._json(200, service.stats())
            else:
                self._json(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            if self.path != "/tag":
                self._json(404, {"error": f"unknown path {self.path}"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                raw = self.rfile.read(n)
                ct = self.headers.get("Content-Type", "")
                if ct.startswith("application/json"):
                    wave = np.asarray(json.loads(raw)["waveform"], np.float32)
                elif ct.startswith("audio/l16"):
                    # registered audio/L16 is BIG-endian (RFC 2586/3555)
                    wave = np.frombuffer(raw, ">i2").astype(np.int16)
                elif ct.startswith("audio/pcm"):
                    wave = np.frombuffer(raw, "<i2").astype(np.int16)
                else:  # copied: torch takes no read-only buffers
                    wave = np.frombuffer(raw, np.float32).copy()
                if wave.size == 0:
                    self._json(400, {"error": "empty waveform"})
                    return
                acts, labels = service.tag(wave)
                order = np.argsort(acts)[::-1][:top_k]
                # head sizes other than 400/519 have no vocabulary
                name = (lambda i: labels[i]) if labels is not None else str
                self._json(200, {
                    "labels": [[name(int(i)), float(acts[i])] for i in order],
                })
            except Exception as e:  # report to the client, keep serving
                self._json(500, {"error": f"{type(e).__name__}: {e}"})

    return Handler


def serve_forever(service, host: str, port: int, top_k: int):
    """Start the HTTP server in a thread; returns (server, thread). Stop
    with ``server.shutdown()``, ``server.server_close()`` and
    ``service.close()``."""
    server = ThreadingHTTPServer((host, port), make_handler(service, top_k))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server, thread


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    service = make_service(args)
    server, thread = serve_forever(service, args.host, args.port, args.top_k)
    print(f"maest-serve-torch: listening on http://{args.host}:"
          f"{server.server_port} (arch={args.arch}, device={args.device}, "
          f"dtype={args.dtype}, buckets={args.buckets})", flush=True)
    try:
        thread.join()
    except KeyboardInterrupt:
        server.shutdown()
        service.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
