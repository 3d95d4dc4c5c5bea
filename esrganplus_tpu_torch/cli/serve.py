"""Minimal inference service over HTTP (stdlib only).

The reference ships batch scripts (``test_image/test.py``); a serving
deployment needs a long-lived process that holds the model on the card. This
wraps :class:`~esrganplus_tpu_torch.infer.SRInferencer` behind three
endpoints. Counterpart of ``esrganplus_tpu/cli/serve.py``:

    python -m esrganplus_tpu_torch.cli.serve MODEL.pth [--host 127.0.0.1]
        [--port 8971] [--dtype bf16|fp32] [--pad-multiple 32] [--x8]
        [--tile N] [--noise-seed N] [--device cuda|cpu]

  * ``POST /upscale`` — body: encoded image bytes (PNG/JPEG/...; BGR file
    conventions as everywhere else) → PNG bytes of the ×N result.
  * ``GET /healthz`` — model/config JSON (200 once the warm-up of the
    serving mode finished — readiness probe).
  * ``GET /stats`` — request counter, output megapixels, latency EWMA.

Serving notes: inputs are edge-padded to a multiple of ``--pad-multiple``
(default 32) and the output cropped back, as the JAX service does to bound
its compiles; the pad differs from the unpadded forward only within the
receptive radius of the pad edge. The device call is serialised with a lock
(one card, one stream); run one process per card and load-balance above for
scale-out. ``--tile`` switches to derived-halo tiling for arbitrarily large
inputs. ``--noise-seed`` is the integer seed of the nESRGAN+ noise mode
(``SRInferencer(noise_rng=)``). Runs on the card (``--device cuda``, the
default) through the CUDA kernels; ``--device cpu`` runs the plain graph.
"""

from __future__ import annotations

import argparse
import json
import threading
import time


def build_handler(inferencer, mode, stats: dict, lock: threading.Lock):
    """``mode``: the per-request upscale callable picked by make_server
    (plain / tiled / x8) — not an instance patch: ``upscale_x8`` calls
    ``self.upscale`` internally, so rebinding the method would recurse."""
    from http.server import BaseHTTPRequestHandler

    from esrganplus_tpu_torch.ops.image_io import decode_img, encode_png, img2tensor, tensor2img

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet; stats carry the signal
            pass

        def _send(self, code: int, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _json(self, code: int, obj):
            self._send(code, json.dumps(obj).encode(), "application/json")

        def do_GET(self):
            if self.path == "/healthz":
                cfg = inferencer.cfg
                self._json(200, {
                    "status": "ok",
                    "model": {"nb": cfg.nb, "nf": cfg.nf, "gc": getattr(cfg, "gc", None),
                              "upscale": cfg.upscale},
                    "device": str(inferencer.device),
                    "requests": stats["requests"],
                })
            elif self.path == "/stats":
                self._json(200, dict(stats))
            else:
                self._json(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path != "/upscale":
                self._json(404, {"error": "unknown path"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                img = decode_img(self.rfile.read(n))
            except Exception as e:
                self._json(400, {"error": f"bad image payload: {e}"})
                return
            t0 = time.perf_counter()
            try:
                rgb = img2tensor(img)
                with lock:
                    out = mode(rgb)
                png = encode_png(tensor2img(out))
            except Exception as e:  # surface as a 500, keep serving
                self._json(500, {"error": str(e)})
                return
            dt = time.perf_counter() - t0
            with lock:  # ThreadingHTTPServer: read-modify-writes must not race
                stats["requests"] += 1
                stats["out_mpix"] = round(
                    stats["out_mpix"] + out.shape[0] * out.shape[1] / 1e6, 3)
                ewma = stats["latency_ewma_s"]
                stats["latency_ewma_s"] = round(
                    dt if ewma == 0 else 0.9 * ewma + 0.1 * dt, 4)
            self._send(200, png, "image/png")

    return Handler


def make_server(args):
    """Build (server, inferencer) — separated from main() for tests."""
    import numpy as np
    import torch

    from esrganplus_tpu_torch.infer import SRInferencer, load_generator

    if args.tile and args.x8:
        raise SystemExit("--tile and --x8 are mutually exclusive (the "
                         "self-ensemble is not defined per tile)")
    params, cfg, _ = load_generator(args.model, device=args.device)
    dtype = torch.bfloat16 if args.dtype == "bf16" else None
    inf = SRInferencer(params, cfg, dtype=dtype, pad_multiple=args.pad_multiple or None,
                       noise_rng=args.noise_seed, device=args.device)
    if args.tile:
        mode = lambda rgb: inf.upscale_tiled(rgb, tile=args.tile)
    elif args.x8:
        mode = inf.upscale_x8
    else:
        mode = inf.upscale

    # warm up the serving mode at one shape so /healthz means "ready" (the
    # kernels' first launch loads their libraries)
    m = max(args.pad_multiple or 32, args.tile or 0)
    mode(np.zeros((m, m, 3), np.float32))

    from http.server import ThreadingHTTPServer

    stats = {"requests": 0, "out_mpix": 0.0, "latency_ewma_s": 0.0}
    handler = build_handler(inf, mode, stats, threading.Lock())
    return ThreadingHTTPServer((args.host, args.port), handler), inf


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="ESRGAN+ inference service (PyTorch/CUDA)")
    ap.add_argument("model", help="path to an RRDBNet or SRResNet .pth checkpoint")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8971)
    ap.add_argument("--dtype", default="bf16", choices=["bf16", "fp32"])
    ap.add_argument("--pad-multiple", type=int, default=32,
                    help="edge-pad inputs to a multiple (0 = exact shapes)")
    ap.add_argument("--tile", type=int, default=0,
                    help="tile large inputs with a derived halo (0 = off)")
    ap.add_argument("--x8", action="store_true",
                    help="geometric self-ensemble per request (8 variants)")
    ap.add_argument("--noise-seed", type=int, default=None,
                    help="activate the nESRGAN+ noise sites with this deterministic seed")
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    server, _ = make_server(args)
    print(f"serving on http://{args.host}:{server.server_address[1]} "
          f"(POST /upscale, GET /healthz, GET /stats)", flush=True)
    server.serve_forever()


if __name__ == "__main__":
    main()
