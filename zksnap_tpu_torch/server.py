"""HTTP proving service (PyTorch port of zksnap_tpu/server.py): the
delivery surface that stands in for the reference's browser/WASM flow.

The reference proves the voter circuit inside the client's browser via
halo2-wasm + a web worker (voter/frontend/wasm/src/lib.rs:39-66,
frontend/app/worker.js:95-168).  Here the same config -> keygen -> prove
-> verify lifecycle is a service over HTTP (stdlib http.server), with the
proving keys resident on the device and each request's witness rebound
(prover/plonk.py `rebind_witness`).

Endpoints (JSON), those of the JAX service:
  GET  /health          -> {"status": "ok", "circuits": [...]}
  POST /prove           {"circuit": "voter", "k": 13, "seed": 7}
                        -> {"proof": hex, "instances": [...], "ms": ...}
  POST /verify          {"circuit": "voter", "k": 13, "proof": hex,
                         "instances": [...]} -> {"valid": bool}

Run: python -m zksnap_tpu_torch.server [port] [device]  (8787, cuda)
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .cli import CIRCUITS, build_circuit


class _ProverPool:
    """Lazily-built, cached (circuit, k) proving keys on `device` and a
    serialized prove: one prove at a time (the card is a serial resource;
    the kernels batch within one proof)."""

    def __init__(self, device="cuda"):
        self.device = device
        self._keys = {}
        self._lock = threading.Lock()

    def _get(self, circuit: str, k: int):
        key = (circuit, k)
        if key in self._keys:
            return self._keys[key]
        from .prover.plonk import keygen
        from .prover.srs import gen_srs

        ctx, _ = build_circuit(circuit, k, seed=0)
        pk = keygen(ctx, k, gen_srs(k, device=self.device))
        self._keys[key] = pk
        return pk

    def prove(self, circuit: str, k: int, seed: int):
        from .prover.plonk import prove, rebind_witness

        with self._lock:
            pk = self._get(circuit, k)
            ctx, instances = build_circuit(circuit, k, seed)
            t0 = time.time()
            proof = prove(rebind_witness(pk, ctx), instances)
            return proof, instances, time.time() - t0

    def verify(self, circuit: str, k: int, proof: bytes, instances):
        from .prover.plonk import verify
        from .prover.srs import gen_srs

        with self._lock:
            pk = self._get(circuit, k)
        srs = gen_srs(k, device=self.device)
        return verify(pk.vk, srs.g2, srs.tau_g2, instances, proof)


class Handler(BaseHTTPRequestHandler):
    """Serves the pool of its server (`make_server`)."""

    def _json(self, code: int, obj):
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *a):  # quiet (print-based logging parity)
        pass

    def do_GET(self):
        if self.path == "/health":
            return self._json(200, {"status": "ok",
                                    "circuits": list(CIRCUITS)})
        return self._json(404, {"error": "not found"})

    def do_POST(self):
        pool = self.server.pool
        try:
            n = int(self.headers.get("Content-Length", 0))
            req = json.loads(self.rfile.read(n) or b"{}")
            circuit = req.get("circuit", "voter")
            k = int(req.get("k", 13))
            if circuit not in CIRCUITS:
                return self._json(400, {"error": "unknown circuit"})
            if self.path == "/prove":
                proof, inst, dt = pool.prove(circuit, k,
                                             int(req.get("seed", 0)))
                return self._json(200, {
                    "proof": proof.hex(),
                    "instances": [str(v) for v in inst],
                    "ms": round(dt * 1000, 1),
                })
            if self.path == "/verify":
                ok = pool.verify(
                    circuit, k, bytes.fromhex(req["proof"]),
                    [int(v) for v in req["instances"]])
                return self._json(200, {"valid": bool(ok)})
            return self._json(404, {"error": "not found"})
        except Exception as e:  # noqa: BLE001 -- a request's failure is its 500
            return self._json(500, {"error": f"{type(e).__name__}: {e}"})


def make_server(port: int = 8787, device="cuda") -> ThreadingHTTPServer:
    """The service bound to 127.0.0.1:`port` (0 picks a free port), its
    keys on `device`; the caller runs `serve_forever` and `shutdown`."""
    httpd = ThreadingHTTPServer(("127.0.0.1", port), Handler)
    httpd.pool = _ProverPool(device)
    return httpd


def serve(port: int = 8787, device="cuda"):
    httpd = make_server(port, device)
    print(f"zksnap_tpu_torch proving service on :{httpd.server_address[1]} "
          f"(circuits: {', '.join(CIRCUITS)}; device {device})", flush=True)
    try:
        httpd.serve_forever()
    finally:
        httpd.server_close()


if __name__ == "__main__":
    import sys

    serve(int(sys.argv[1]) if len(sys.argv) > 1 else 8787,
          sys.argv[2] if len(sys.argv) > 2 else "cuda")
