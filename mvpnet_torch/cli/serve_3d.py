"""CLI: serve chunk inference from an exported artifact over HTTP.

Counterpart of ``python -m mvpnet_tpu.cli.serve_3d`` (stdlib only): loads a
``torch.export`` artifact (cli/export_3d.py) and serves

  GET  /meta      -> the artifact's meta.json (shapes, dtypes, classes)
  GET  /healthz   -> 200 "ok"
  POST /predict   -> body: npz with the artifact's input arrays
                     response: npz {"logits": (B, N, C) float32}

Usage:
  python -m mvpnet_torch.cli.serve_3d --artifact artifacts/mvpnet3d \\
      [--host 127.0.0.1] [--port 8476]

A bad request (a missing input, a body that is no npz, a wrong shape) gets
400 with a JSON error and the server stays up. One lock serializes the
requests' host-to-device copies, forwards and device-to-host copies, so two
requests never interleave on the card's stream; batching belongs in the
client (the artifact's batch dim is fixed at export time).
"""
from __future__ import annotations

import argparse
import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from mvpnet_torch.eval.export_model import load_inference
from mvpnet_torch.utils.logger import setup_logger


def make_handler(loaded, lock):
    class Handler(BaseHTTPRequestHandler):
        def _send(self, code, body: bytes, ctype="application/octet-stream"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/meta":
                self._send(200, json.dumps(loaded.meta).encode(), "application/json")
            elif self.path == "/healthz":
                self._send(200, b"ok", "text/plain")
            else:
                self._send(404, b"not found", "text/plain")

        def do_POST(self):
            if self.path != "/predict":
                self._send(404, b"not found", "text/plain")
                return
            try:
                n = int(self.headers.get("Content-Length", "0"))
                with np.load(io.BytesIO(self.rfile.read(n))) as z:
                    batch = {k: z[k] for k in z.files}
                missing = set(loaded.meta["input_spec"]) - set(batch)
                if missing:
                    raise KeyError(f"missing inputs: {sorted(missing)}")
                with lock:
                    logits = loaded(batch).float().cpu().numpy()
                buf = io.BytesIO()
                np.savez(buf, logits=logits)
                self._send(200, buf.getvalue())
            except Exception as e:  # report, don't kill the server
                self._send(400, json.dumps({"error": f"{type(e).__name__}: {e}"}).encode(), "application/json")

        def log_message(self, fmt, *args):  # no per-request access log
            pass

    return Handler


def serve(artifact: str, host: str = "127.0.0.1", port: int = 8476):
    """The server of ``artifact`` bound to (host, port), not yet serving
    (port 0: any free port, ``server_address`` says which)."""
    logger = setup_logger(output_dir=None)
    loaded = load_inference(artifact)
    lock = threading.Lock()
    httpd = ThreadingHTTPServer((host, port), make_handler(loaded, lock))
    logger.info("serving %s on http://%s:%d (inputs: %s)", artifact, host, httpd.server_address[1],
                list(loaded.meta["input_spec"]))
    return httpd


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--artifact", required=True)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8476)
    args = ap.parse_args(argv)
    httpd = serve(args.artifact, args.host, args.port)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        httpd.shutdown()
    finally:
        httpd.server_close()


if __name__ == "__main__":
    main()
