"""Stdlib-only JSON HTTP surface for a PoolService.

ThreadingHTTPServer + BaseHTTPRequestHandler — no third-party web
framework.  Handler threads are safe because every service verb funnels
through the wall-clock driver's quiescent injection point; the HTTP
layer is a thin JSON codec over PoolService.

  GET  /healthz        liveness + current sim time
  GET  /status         queue depths, backends, driver state
  GET  /metrics        gauges + per-backend cost/waste + EUP + series
  GET  /metrics.prom   Prometheus text exposition (text/plain; 0.0.4)
  GET  /trace          Chrome trace-event JSON (telemetry must be on)
  GET  /job?jid=N      one job's state (live or terminal index)
  POST /submit         {"records": [...], "schedd"?, "at_trace_times"?,
                        "at"?} -> jids / scheduled count
  POST /rm             {"jid": N}
  POST /snapshot       {"path"?} -> save to path, or return the full
                        snapshot document inline
  POST /drain-backend  {"name", "at"?}
  POST /add-backend    {"ini": "[backend:x]\\n..."}
  POST /add-schedd     {"name", "quota"?}
  POST /drain-schedd   {"name", "at"?}
  POST /start          {"speed"?}   start the wall-clock driver
  POST /stop           {}           pause it (quiescent)
  POST /shutdown       {}           stop driver and HTTP server

Errors map to 400 (bad request / ValueError / KeyError) or 404 (unknown
route) with a JSON {"error": ...} body.
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from repro_torch.service.pool import PoolService


class _Handler(BaseHTTPRequestHandler):
    # the server instance carries .service (see serve())
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):     # quiet; the CLI prints its own
        pass

    @property
    def service(self) -> PoolService:
        return self.server.service  # type: ignore[attr-defined]

    def _send(self, code: int, obj) -> None:
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _send_text(self, code: int, text: str,
                   content_type: str = "text/plain; charset=utf-8") -> None:
        body = text.encode()
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _body(self) -> dict:
        n = int(self.headers.get("Content-Length") or 0)
        if n == 0:
            return {}
        return json.loads(self.rfile.read(n).decode() or "{}")

    def _route(self, handler) -> None:
        try:
            self._send(200, handler())
        except (ValueError, KeyError, TypeError) as e:
            self._send(400, {"error": f"{type(e).__name__}: {e}"})

    # -- GET -----------------------------------------------------------------
    def do_GET(self):
        url = urlparse(self.path)
        svc = self.service
        if url.path == "/healthz":
            self._route(lambda: {"ok": True,
                                 "t": svc.status()["t"]})
        elif url.path == "/status":
            self._route(svc.status)
        elif url.path == "/metrics":
            self._route(svc.metrics)
        elif url.path == "/metrics.prom":
            try:
                self._send_text(
                    200, svc.metrics_prom(),
                    "text/plain; version=0.0.4; charset=utf-8")
            except (ValueError, KeyError, TypeError) as e:
                self._send(400, {"error": f"{type(e).__name__}: {e}"})
        elif url.path == "/trace":
            self._route(svc.trace)
        elif url.path == "/job":
            q = parse_qs(url.query)
            self._route(lambda: svc.job_status(int(q["jid"][0])))
        else:
            self._send(404, {"error": f"no route {url.path!r}"})

    # -- POST ----------------------------------------------------------------
    def do_POST(self):
        url = urlparse(self.path)
        svc = self.service
        try:
            body = self._body()
        except json.JSONDecodeError as e:
            self._send(400, {"error": f"bad JSON body: {e}"})
            return
        if url.path == "/submit":
            self._route(lambda: svc.submit(
                body.get("records") or [],
                schedd=body.get("schedd"),
                at_trace_times=bool(body.get("at_trace_times", False)),
                at=body.get("at")))
        elif url.path == "/rm":
            self._route(lambda: svc.rm(int(body["jid"])))
        elif url.path == "/snapshot":
            path = body.get("path")
            self._route((lambda: svc.save_snapshot(path)) if path
                        else svc.snapshot)
        elif url.path == "/drain-backend":
            self._route(lambda: svc.drain_backend(
                body["name"], at=body.get("at")))
        elif url.path == "/add-backend":
            self._route(lambda: svc.add_backend(body["ini"]))
        elif url.path == "/add-schedd":
            self._route(lambda: svc.add_schedd(
                body["name"], quota=float(body.get("quota", 1.0))))
        elif url.path == "/drain-schedd":
            self._route(lambda: svc.drain_schedd(
                body["name"], at=body.get("at")))
        elif url.path == "/start":
            def start():
                speed = body.get("speed", "unchanged")
                svc.start(speed=speed)
                return {"running": True, "speed": svc.driver.speed}
            self._route(start)
        elif url.path == "/stop":
            def stop():
                svc.stop()
                return {"running": False}
            self._route(stop)
        elif url.path == "/shutdown":
            def shutdown():
                svc.stop()
                threading.Thread(target=self.server.shutdown,
                                 daemon=True).start()
                return {"ok": True}
            self._route(shutdown)
        else:
            self._send(404, {"error": f"no route {url.path!r}"})


def serve(service: PoolService, host: str = "127.0.0.1",
          port: int = 0) -> ThreadingHTTPServer:
    """Bind the service on (host, port); port 0 picks an ephemeral one
    (read it back from ``server.server_address``).  Call
    ``server.serve_forever()`` — or run it on a thread via
    `serve_in_thread` — and POST /shutdown (or server.shutdown()) to
    stop."""
    server = ThreadingHTTPServer((host, port), _Handler)
    server.daemon_threads = True
    server.service = service  # type: ignore[attr-defined]
    return server


def serve_in_thread(service: PoolService, host: str = "127.0.0.1",
                    port: int = 0):
    """Start the HTTP server on a daemon thread; returns
    (server, base_url)."""
    server = serve(service, host, port)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    addr, bound_port = server.server_address[:2]
    return server, f"http://{addr}:{bound_port}"
