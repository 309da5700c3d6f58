"""HTTP health, metrics and admin endpoint (stdlib asyncio, no deps).

The port's own copy of `distributed_lms_raft_llm_tpu/utils/healthz.py`, so
a port tutoring node exposes the same operator surface as a JAX one:

    GET /healthz      -> the node's health document (`draining`, `queued`,
                         `node_id`, `sessions`: what the fleet router's
                         health poller reads)
    GET /metrics      -> the `Metrics.snapshot()` JSON
    GET /metrics.prom -> the same snapshot in Prometheus text exposition
                         (`utils/timeline.render_prometheus`: HELP/TYPE
                         from `utils/metrics_registry.py`)
    POST /admin/*     -> the admin hook (JSON body in, JSON out), e.g.
                         POST /admin/drain
    GET /admin/*      -> the read-only admin hook, e.g. GET /admin/trace

Handlers raise KeyError for an unknown path (404) and ValueError for a bad
request (400). The server is an asyncio protocol on the node's own event
loop, not a thread.
"""

from __future__ import annotations

import asyncio
import json
from typing import Awaitable, Callable, Dict, Optional

from .metrics import Metrics
from .timeline import render_prometheus

Provider = Callable[[], Dict]
AdminHandler = Callable[[str, Dict], Awaitable[Dict]]
AdminGetHandler = Callable[[str], Awaitable[Dict]]


class HealthServer:
    def __init__(self, metrics: Metrics, *,
                 health: Optional[Provider] = None,
                 admin: Optional[AdminHandler] = None,
                 admin_get: Optional[AdminGetHandler] = None,
                 host: str = "127.0.0.1", port: int = 0):
        self.metrics = metrics
        self.health = health or (lambda: {"ok": True})
        self.admin = admin
        self.admin_get = admin_get
        self.host = host
        self.port = port
        self._server: Optional[asyncio.AbstractServer] = None

    async def start(self) -> int:
        """Bind and serve; returns the bound port (for port=0)."""
        self._server = await asyncio.start_server(self._handle, self.host,
                                                  self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        return self.port

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None

    @staticmethod
    async def _call(fn, *args) -> tuple:
        """(body, status) of one admin handler call, errors mapped."""
        try:
            return json.dumps(await fn(*args)), 200
        except KeyError:
            return json.dumps({"error": "not found"}), 404
        except ValueError as e:
            return json.dumps({"error": str(e)}), 400
        except Exception as e:  # surfaced, not swallowed
            return json.dumps({"error": str(e)}), 500

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        try:
            request_line = await asyncio.wait_for(reader.readline(), 5.0)
            parts = request_line.decode("latin-1").split()
            method = parts[0].upper() if parts else "GET"
            path = parts[1] if len(parts) >= 2 else "/"
            content_length = 0
            while True:
                line = await asyncio.wait_for(reader.readline(), 5.0)
                if line in (b"\r\n", b"\n", b""):
                    break
                if line.lower().startswith(b"content-length:"):
                    try:
                        content_length = max(0, int(line.split(b":", 1)[1]))
                    except ValueError:
                        pass
            ctype = "application/json"
            if path == "/healthz":
                body, status = json.dumps(self.health()), 200
            elif path == "/metrics":
                body, status = json.dumps(self.metrics.snapshot()), 200
            elif path == "/metrics.prom":
                body, status = render_prometheus(self.metrics.snapshot()), 200
                ctype = "text/plain; version=0.0.4; charset=utf-8"
            elif (method == "GET" and path.startswith("/admin/")
                  and self.admin_get is not None):
                body, status = await self._call(self.admin_get, path)
            elif (method == "POST" and path.startswith("/admin/")
                  and self.admin is not None):
                raw = b""
                if content_length:
                    raw = await asyncio.wait_for(
                        reader.readexactly(min(content_length, 1 << 20)), 5.0)
                try:
                    req = json.loads(raw.decode() or "{}")
                except ValueError as e:
                    body, status = json.dumps({"error": str(e)}), 400
                else:
                    body, status = await self._call(self.admin, path, req)
            else:
                body, status = json.dumps({"error": "not found"}), 404
            payload = body.encode()
            reason = {200: "OK", 400: "Bad Request", 404: "Not Found",
                      500: "Internal Server Error"}.get(status, "Error")
            writer.write(
                (f"HTTP/1.1 {status} {reason}\r\n"
                 f"Content-Type: {ctype}\r\n"
                 f"Content-Length: {len(payload)}\r\n"
                 "Connection: close\r\n\r\n").encode() + payload)
            await writer.drain()
        except (asyncio.TimeoutError, ConnectionError, EOFError):
            # EOFError covers IncompleteReadError: a client that closes
            # mid-body gets no response (its connection is gone anyway).
            pass
        finally:
            writer.close()
            try:
                await asyncio.wait_for(writer.wait_closed(), 1.0)
            except (asyncio.TimeoutError, ConnectionError):
                pass
