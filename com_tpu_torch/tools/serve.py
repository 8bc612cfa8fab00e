"""Serve an exported artifact over HTTP with micro-batching (counterpart of
``tools/serve.py``; and ``--device``).

    python -m com_tpu_torch.tools.export --cfg_file CFG --output out/model
    python -m com_tpu_torch.tools.serve --artifact out/model --port 8008 \\
        [--max_wait_ms 20] [--score_thresh 0.1] [--device cpu]

Protocol (standard library only):
  POST /infer   body = raw little-endian float32 bytes of an (n, F) point
                array (F from the manifest); header X-Num-Feats, when given,
                must equal F.  Response: JSON {"boxes": [[...7]], "scores":
                [...], "labels": [...]}, the detections at or above the
                score threshold.
  GET  /stats   JSON micro-batching stats (occupancy, mean infer ms).
  GET  /health  200 once the artifact has answered a warm-up scene, else 503.
Errors are JSON: 400 for a malformed request, 503 when the queue times
out, 500 for a failure inside inference.

The artifact is loaded without any model code (``load_artifact``).
Concurrent POSTs share device batches through ``BatchServer``: the handler
threads wait on their futures while its one dispatch thread runs full
(B, N, F) batches.  ``--port 0`` binds a free port; the first line printed
names the address.
"""
from __future__ import annotations

import argparse
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np


def make_handler(server, manifest: dict, ready: threading.Event):
    """The request handler class over a ``BatchServer`` of the artifact
    described by ``manifest``; /health answers 200 once ``ready`` is set."""
    nf = server.num_feats

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _json(self, code, obj):
            blob = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(blob)))
            self.end_headers()
            self.wfile.write(blob)

        def do_GET(self):
            if self.path == "/health":
                self._json(200 if ready.is_set() else 503,
                           {"ready": ready.is_set(), "model": manifest["model"],
                            "classes": manifest["class_names"]})
            elif self.path == "/stats":
                self._json(200, server.stats.as_dict())
            else:
                self._json(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path != "/infer":
                return self._json(404, {"error": "unknown path"})
            n = int(self.headers.get("Content-Length", 0))
            raw = self.rfile.read(n)
            if len(raw) % (4 * nf):
                return self._json(400, {"error": f"body must be float32 (n, {nf}) bytes"})
            hdr_nf = self.headers.get("X-Num-Feats")
            if hdr_nf is not None and hdr_nf != str(nf):
                return self._json(400, {"error": f"X-Num-Feats={hdr_nf} but the artifact "
                                                 f"expects {nf} features per point"})
            pts = np.frombuffer(raw, np.float32).reshape(-1, nf)
            try:
                out = server.infer(pts)
            except ValueError as e:
                return self._json(400, {"error": str(e)})
            except TimeoutError:
                return self._json(503, {"error": "inference queue timed out"})
            except Exception as e:  # surface as JSON, not a dropped socket
                return self._json(500, {"error": f"{type(e).__name__}: {e}"})
            self._json(200, {"boxes": out["boxes"].tolist(), "scores": out["scores"].tolist(),
                             "labels": out["labels"].tolist()})

    return Handler


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--artifact", required=True, help="artifact stem (no extension)")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8008)
    parser.add_argument("--max_wait_ms", type=float, default=20.0)
    parser.add_argument("--score_thresh", type=float, default=0.1)
    parser.add_argument("--device", type=str, default="cuda", help="cuda (the default) or cpu")
    args = parser.parse_args(argv)

    from ..serving import BatchServer
    from ..utils.device import resolve_device
    from ..utils.serving import load_artifact

    dev = resolve_device(args.device)
    run, manifest = load_artifact(args.artifact, device=dev)
    server = BatchServer(run, manifest["input_spec"], max_wait_ms=args.max_wait_ms,
                         score_thresh=args.score_thresh, device=dev)
    ready = threading.Event()

    def warmup():
        server.infer(np.zeros((1, server.num_feats), np.float32))
        ready.set()

    threading.Thread(target=warmup, daemon=True).start()
    httpd = ThreadingHTTPServer((args.host, args.port), make_handler(server, manifest, ready))
    print(f"serving {manifest['model']} on http://{args.host}:{httpd.server_address[1]} "
          f"(batch {server.batch_size}, cap {server.max_points} points, {dev})", flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        server.close()


if __name__ == "__main__":
    main()
