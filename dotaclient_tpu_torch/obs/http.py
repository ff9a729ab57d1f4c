"""Scrape surface (torch twin of dotaclient_tpu/obs/http.py, the learner's
routes): stdlib-only GET /metrics in Prometheus text format, a structured
GET /healthz, and on-demand POST /profile capture.

/healthz returns the JSON body of the optional `health_provider`: HTTP 200
when its "ok" is true and 503 when not (the k8s liveness-probe contract).
With no provider it is a plain 200 {"ok": true}.

GET /debug/flight?max_events=N returns the flight recorder's bounded live
snapshot (`flight_provider`), 404 when none is wired.

POST /profile?seconds=N runs `profile_handler(seconds)` (obs/compute.py
ProfileCapture) and returns {"trace_dir", "seconds"}; 409 while a capture
is in flight, 500 when the capture fails (never an empty trace), 404 when
no handler is wired.

Exposition: `# TYPE <name> gauge` then `<name> <value>` per metric, names
sanitized to [a-zA-Z_:][a-zA-Z0-9_:]* and prefixed `dotaclient_`, values
printed with .10g, non-finite values skipped. Sources are zero-arg
callables returning {name: number}, called fresh per scrape; a source that
raises is skipped for that scrape.
"""

from __future__ import annotations

import json
import logging
import math
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, List, Optional
from urllib.parse import parse_qs, urlparse

_log = logging.getLogger(__name__)


class CaptureBusyError(RuntimeError):
    """A profiler capture is already in flight (the profiler is process-global);
    POST /profile answers it with 409. Defined here, not in obs/compute.py,
    so this stdlib module never imports torch."""


_NAME_OK = re.compile(r"[^a-zA-Z0-9_:]")


def sanitize_metric_name(name: str, prefix: str = "dotaclient_") -> str:
    name = _NAME_OK.sub("_", name)
    if name and name[0].isdigit():
        name = f"_{name}"
    return f"{prefix}{name}"


def render_prometheus(scalars: Dict[str, float], prefix: str = "dotaclient_") -> str:
    lines: List[str] = []
    for name in sorted(scalars):
        try:
            v = float(scalars[name])
        except (TypeError, ValueError):
            continue
        if not math.isfinite(v):
            continue
        pname = sanitize_metric_name(name, prefix)
        lines.append(f"# TYPE {pname} gauge")
        lines.append(f"{pname} {v:.10g}")
    return "\n".join(lines) + "\n"


class MetricsHTTPServer:
    """One daemon thread serving GET /metrics + GET /healthz (+ POST
    /profile when a handler is wired) until stop(). Sources are sampled per
    scrape; port=0 binds an ephemeral port, read back via `.port`.

    A service adds its own JSON routes: `json_routes` (GET path → zero-arg
    callable), `query_routes` (GET path → callable of the parsed query,
    {name: [values]}) and `post_routes` (POST path → callable of the body
    bytes). A route raising KeyError or ValueError answers 400, anything
    else 500; the serving thread lives on."""

    def __init__(self, port: int, sources: Optional[List[Callable[[], Dict[str, float]]]] = None,
                 health_provider: Optional[Callable[[], Dict]] = None,
                 profile_handler: Optional[Callable[[float], object]] = None,
                 flight_provider: Optional[Callable[..., Dict]] = None,
                 json_routes: Optional[Dict[str, Callable[[], Dict]]] = None,
                 query_routes: Optional[Dict[str, Callable[[Dict], Dict]]] = None,
                 post_routes: Optional[Dict[str, Callable[[bytes], Dict]]] = None):
        self._sources: List[Callable[[], Dict[str, float]]] = list(sources or [])
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._requested_port = port
        self.health_provider = health_provider
        self.profile_handler = profile_handler
        self.flight_provider = flight_provider
        self.json_routes: Dict[str, Callable[[], Dict]] = dict(json_routes or {})
        self.query_routes: Dict[str, Callable[[Dict], Dict]] = dict(query_routes or {})
        self.post_routes: Dict[str, Callable[[bytes], Dict]] = dict(post_routes or {})
        # Boot-epoch fence for aggregators: a changed value tells a counter
        # reset (restart) from a counter loss.
        self._boot_epoch_ms = float(int(time.time() * 1000.0))

    def add_source(self, source: Callable[[], Dict[str, float]]) -> None:
        self._sources.append(source)

    def health(self) -> Dict:
        """The /healthz body; a provider that raises reads as unhealthy."""
        provider = self.health_provider
        if provider is None:
            return {"ok": True}
        try:
            body = dict(provider())
        except Exception as e:
            _log.exception("health provider failed")
            return {"ok": False, "error": f"health provider failed: {type(e).__name__}"}
        body.setdefault("ok", True)
        return body

    def collect(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for source in tuple(self._sources):
            try:
                out.update(source())
            except Exception:
                _log.exception("metrics source failed; skipping for this scrape")
        out["obs_boot_epoch_ms"] = self._boot_epoch_ms
        return out

    @property
    def port(self) -> int:
        return self._httpd.server_address[1] if self._httpd else self._requested_port

    def start(self) -> "MetricsHTTPServer":
        server = self

        class Handler(BaseHTTPRequestHandler):
            def _reply(self, code: int, body: bytes, ctype: str) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _reply_json(self, code: int, payload: Dict) -> None:
                self._reply(code, (json.dumps(payload) + "\n").encode(), "application/json")

            def do_GET(self):
                route = self.path.split("?", 1)[0]
                if route == "/metrics":
                    self._reply(200, render_prometheus(server.collect()).encode(),
                                "text/plain; version=0.0.4; charset=utf-8")
                elif route == "/healthz":
                    body = server.health()
                    self._reply_json(200 if body.get("ok", True) else 503, body)
                elif route == "/debug/flight":
                    provider = server.flight_provider  # one read
                    if provider is None:
                        self._reply_json(404, {"error": "no flight recorder wired on this surface"})
                        return
                    try:
                        max_events = int(parse_qs(urlparse(self.path).query).get("max_events", ["256"])[0])
                    except ValueError:
                        max_events = 256
                    try:
                        body = dict(provider(max_events=max_events))
                    except Exception as e:
                        _log.exception("flight snapshot failed")
                        self._reply_json(500, {"error": f"{type(e).__name__}: {e}"})
                        return
                    self._reply_json(200, body)
                elif route in server.json_routes:
                    self._route(route, server.json_routes[route])
                elif route in server.query_routes:
                    params = parse_qs(urlparse(self.path).query)
                    self._route(route, lambda: server.query_routes[route](params))
                else:
                    self.send_error(404)

            def _route(self, route: str, call) -> None:
                try:
                    body = dict(call())
                except (KeyError, ValueError) as e:
                    self._reply_json(400, {"error": f"{type(e).__name__}: {e}"})
                    return
                except Exception as e:
                    _log.exception("route %s failed", route)
                    self._reply_json(500, {"error": f"{type(e).__name__}: {e}"})
                    return
                self._reply_json(200, body)

            def do_POST(self):
                parsed = urlparse(self.path)
                if parsed.path in server.post_routes:
                    try:
                        length = int(self.headers.get("Content-Length") or 0)
                    except ValueError:
                        length = 0
                    data = self.rfile.read(length) if length > 0 else b""
                    self._route(parsed.path, lambda: server.post_routes[parsed.path](data))
                    return
                if parsed.path != "/profile":
                    self.send_error(404)
                    return
                if server.profile_handler is None:
                    self._reply_json(404, {"error": "no profiler wired on this surface"})
                    return
                try:
                    seconds = float(parse_qs(parsed.query).get("seconds", ["5"])[0])
                except ValueError:
                    seconds = math.nan
                if not math.isfinite(seconds):
                    self._reply_json(400, {"error": "seconds must be a finite number"})
                    return
                try:
                    path = server.profile_handler(seconds)
                except Exception as e:
                    busy = isinstance(e, CaptureBusyError)
                    if not busy:
                        _log.exception("profile capture failed")
                    self._reply_json(409 if busy else 500, {"error": f"{type(e).__name__}: {e}"})
                    return
                if isinstance(path, tuple):  # (path, the window actually traced)
                    path, seconds = path
                self._reply_json(200, {"trace_dir": path, "seconds": seconds})

            def log_message(self, fmt, *args):  # scrape spam stays out of stderr
                pass

        self._httpd = ThreadingHTTPServer(("", self._requested_port), Handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True, name="obs-metrics-http")
        self._thread.start()
        _log.info("obs /metrics serving on port %d", self.port)
        return self

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
