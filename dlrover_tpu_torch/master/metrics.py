"""Master ``/metrics`` endpoint (prometheus text format, stdlib only): the
port's own copy of dlrover_tpu/master/metrics.py.

The control plane's own health (RPC queue depth, shed counters, goodput,
downtime, straggler count) as gauges, and, when the goodput planner is
armed, its decision counters and last-decision gauges
(``dlrover_tpu_scale_decisions_total``, brain/planner.py). Enabled by
``DLROVER_TPU_MASTER_METRICS_PORT`` (0 = ephemeral).
"""

from __future__ import annotations

import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, List, Optional

from dlrover_tpu_torch.common.log import logger


class MasterMetricsServer:
    """Serves ``GET /metrics`` from a list of line providers (each a
    zero-arg callable returning prometheus text lines)."""

    def __init__(self, port: int = 0):
        self._providers: List[Callable[[], List[str]]] = []
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._port = int(port)
        self.port: int = 0

    def add_provider(self, provider: Callable[[], List[str]]):
        self._providers.append(provider)

    def _render(self) -> str:
        lines: List[str] = []
        for provider in self._providers:
            try:
                lines.extend(provider())
            except Exception:
                logger.exception("master metrics provider failed")
        return "\n".join(lines) + "\n"

    def start(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (stdlib API)
                if self.path.rstrip("/") not in ("", "/metrics".rstrip("/")):
                    self.send_error(404)
                    return
                body = server._render().encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):  # quiet
                pass

        self._httpd = ThreadingHTTPServer(("0.0.0.0", self._port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name="master-metrics",
            daemon=True,
        )
        self._thread.start()
        logger.info("master /metrics serving on port %s", self.port)

    def stop(self):
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None


def speed_monitor_lines(speed_monitor) -> List[str]:
    """Control-plane health gauges from the SpeedMonitor."""
    lines = [
        "# TYPE dlrover_tpu_master_goodput gauge",
        f"dlrover_tpu_master_goodput {speed_monitor.goodput():.6f}",
        f"dlrover_tpu_master_global_step "
        f"{speed_monitor.completed_global_step}",
        f"dlrover_tpu_master_downtime_seconds_total "
        f"{speed_monitor.total_downtime():.3f}",
        f"dlrover_tpu_master_stragglers "
        f"{len(speed_monitor.stragglers())}",
        f"dlrover_tpu_master_running_workers "
        f"{len(speed_monitor.running_workers)}",
    ]
    return lines


def maybe_start(
    rpc_server, speed_monitor, planner=None
) -> Optional[MasterMetricsServer]:
    """Boot the endpoint when ``DLROVER_TPU_MASTER_METRICS_PORT`` is set:
    the RPC gate's depth and shed counters, the goodput gauges and (when
    the goodput planner is armed) ``dlrover_tpu_scale_decisions_total``
    and the last-decision gauges."""
    from dlrover_tpu_torch.common import flags

    if not flags.MASTER_METRICS_PORT.present():
        return None
    server = MasterMetricsServer(port=int(flags.MASTER_METRICS_PORT.get()))
    if rpc_server is not None:
        server.add_provider(rpc_server.gate.prometheus_lines)
    if speed_monitor is not None:
        server.add_provider(lambda: speed_monitor_lines(speed_monitor))
    if planner is not None:
        server.add_provider(planner.prometheus_lines)
    try:
        server.start()
    except OSError as e:
        logger.warning("master metrics server failed to start: %s", e)
        return None
    return server
