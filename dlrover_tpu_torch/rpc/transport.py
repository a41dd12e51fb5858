"""Control-plane transport: the port's counterpart of
dlrover_tpu/rpc/transport.py, over the standard library's HTTP.

The JAX package carries the control plane over gRPC: one service with two
generic raw-bytes methods, ``/dlrover_tpu.Master/get`` and ``/report``,
whose payloads are the serde JSON of :mod:`dlrover_tpu_torch.common.serde`.
The port keeps that shape (the two method paths, the same serde bytes, the
cheap ``dlrover-node-id`` header, the admission gate and the retry policy
of :mod:`dlrover_tpu_torch.rpc.policy`) and carries it over
``http.server.ThreadingHTTPServer`` and ``http.client`` instead, as an HTTP
POST to the method's path: the port imports the standard library, numpy
and torch only, and the machines it runs on need not have ``grpc``.

- The server runs every request through a :class:`RequestGate`: a bounded
  admission counter that sheds excess load with an explicit
  ``OverloadedResponse`` instead of queueing it. Reports shed first (they
  are periodic and resendable); gets shed at a higher watermark.
- The client retries through the policy: jittered exponential backoff with
  a budget, and the error taxonomy. A refused or dropped connection is
  ``unavailable``, a timeout ``deadline``, and an HTTP error status an
  :class:`RpcError` with gRPC's code names (``INTERNAL`` for a handler that
  raised), so :func:`policy.classify` reads both transports alike.
"""

from __future__ import annotations

import dataclasses
import http.client
import random
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional

from dlrover_tpu_torch.common import messages as msg
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.common.serde import (
    UnknownMessageError,
    deserialize,
    serialize,
)
from dlrover_tpu_torch.rpc import policy as rpc_policy
from dlrover_tpu_torch.rpc.policy import OverloadedError

SERVICE = "dlrover_tpu.Master"
GET = f"/{SERVICE}/get"
REPORT = f"/{SERVICE}/report"
#: the cheap node-id header: lets the admission gate record WHICH node
#: it shed before paying any deserialization (shed-aware liveness)
NODE_ID_HEADER = "dlrover-node-id"
#: the largest request body the server reads (gRPC's message cap there)
MAX_MESSAGE_BYTES = 256 * 1024 * 1024


@dataclasses.dataclass(frozen=True)
class _Code:
    name: str


class RpcError(Exception):
    """The server answered with an error status; ``code().name`` is the
    gRPC status name the JAX transport would have raised."""

    def __init__(self, code_name: str, details: str = ""):
        self._code = _Code(code_name)
        super().__init__(f"{code_name}: {details}")

    def code(self) -> _Code:
        return self._code


class RequestGate:
    """Bounded admission for the servicer.

    Admission above ``report_cap`` (or ``get_cap`` for gets) is refused:
    the caller returns the ``OverloadedResponse`` of
    :meth:`overload_reply`, so saturation turns into explicit,
    bounded-latency sheds instead of an invisible queue."""

    def __init__(self, report_cap: int = 16, get_cap: Optional[int] = None):
        self.report_cap = max(1, int(report_cap))
        # gets shed later: a shed get stalls the caller's actual work
        self.get_cap = (
            max(self.report_cap, int(get_cap))
            if get_cap is not None
            else self.report_cap * 2
        )
        # the liveness ceiling advertised on Overloaded replies: how far
        # a client may widen its report cadence before the heartbeat
        # evictor would declare it dead. 0 = don't advertise.
        self.liveness_ceiling_s = 0.0
        self.clock = time.time
        self._lock = threading.Lock()
        self._inflight = 0
        self._inflight_reports = 0
        self._peak = 0
        #: admitted and shed requests by kind ("get", "report"), for the
        #: master's /metrics
        self._served: Dict[str, int] = {}
        self._rejected: Dict[str, int] = {}
        # shed-aware liveness: node_id -> last shed timestamp, so the
        # heartbeat evictor never evicts a worker the master silenced.
        # Bounded; pruned oldest-first past the cap.
        self._shed_nodes: Dict[int, float] = {}
        self._shed_cap = 8192

    def try_enter(self, kind: str, node_id: int = -1) -> bool:
        with self._lock:
            if kind == "get":
                # gets compete for the TOTAL budget (they shed last)
                admitted = self._inflight < self.get_cap
            else:
                # reports compete only with other reports: a get-heavy
                # episode must never starve heartbeats and failure reports
                admitted = self._inflight_reports < self.report_cap
            if not admitted:
                self._rejected[kind] = self._rejected.get(kind, 0) + 1
                if node_id >= 0:
                    self._shed_nodes[node_id] = self.clock()
                    if len(self._shed_nodes) > self._shed_cap:
                        oldest = min(
                            self._shed_nodes, key=self._shed_nodes.get
                        )
                        del self._shed_nodes[oldest]
                return False
            self._inflight += 1
            if kind != "get":
                self._inflight_reports += 1
            self._peak = max(self._peak, self._inflight)
            self._served[kind] = self._served.get(kind, 0) + 1
            return True

    def recently_shed(
        self, node_id: int, window_s: float, now: Optional[float] = None
    ) -> bool:
        """Did the gate shed a request from this node within the window?
        The heartbeat evictor treats such a node as alive."""
        with self._lock:
            ts = self._shed_nodes.get(int(node_id))
        if ts is None:
            return False
        now = self.clock() if now is None else now
        return now - ts <= window_s

    def leave(self, kind: str = "report"):
        with self._lock:
            self._inflight = max(0, self._inflight - 1)
            if kind != "get":
                self._inflight_reports = max(0, self._inflight_reports - 1)

    def stats(self) -> Dict:
        with self._lock:
            return {
                "inflight": self._inflight,
                "peak_inflight": self._peak,
                "report_cap": self.report_cap,
                "get_cap": self.get_cap,
                "served": dict(self._served),
                "rejected": dict(self._rejected),
            }

    def prometheus_lines(self) -> List[str]:
        """The gate's gauges and counters for the master's /metrics
        (master/metrics.py)."""
        s = self.stats()
        lines = [
            "# TYPE dlrover_tpu_master_rpc_inflight gauge",
            f"dlrover_tpu_master_rpc_inflight {s['inflight']}",
            f"dlrover_tpu_master_rpc_inflight_peak {s['peak_inflight']}",
            "# TYPE dlrover_tpu_master_rpc_total counter",
        ]
        for kind in sorted(s["served"]):
            lines.append(
                f'dlrover_tpu_master_rpc_total{{method="{kind}",'
                f'outcome="served"}} {s["served"][kind]}'
            )
        for kind in sorted(s["rejected"]):
            lines.append(
                f'dlrover_tpu_master_rpc_total{{method="{kind}",'
                f'outcome="rejected"}} {s["rejected"][kind]}'
            )
        return lines

    @staticmethod
    def _retry_hint_s(depth: int) -> float:
        """Shed-reply backoff hint: grows with depth so a deeper overload
        pushes the clients further out."""
        return min(10.0, max(0.5, 0.05 * depth))

    def overload_reply(self, kind: str = "report"):
        with self._lock:
            depth = self._inflight
        return msg.OverloadedResponse(
            retry_after_s=self._retry_hint_s(depth),
            queue_depth=depth,
            reason=f"{kind} admission cap reached",
            max_interval_s=self.liveness_ceiling_s,
        )


class _HttpServer(ThreadingHTTPServer):
    daemon_threads = True
    # many agents reconnect at once after a master relaunch
    request_queue_size = 128


class RpcServer:
    """Serves a servicer object exposing ``get(msg)`` / ``report(msg)``
    on ``0.0.0.0:port`` (0 = a free port, read back from ``.port``)."""

    def __init__(
        self,
        servicer,
        port: int = 0,
        max_workers: int = 32,
        gate: Optional[RequestGate] = None,
    ):
        self._servicer = servicer
        if gate is None:
            # admission caps below the worker count, as the JAX transport
            # sizes them against its gRPC thread pool by default: shed
            # replies need free threads to stay fast
            cap = min(max(8, max_workers // 2), max(1, max_workers - 8))
            gate = RequestGate(report_cap=cap, get_cap=min(
                max_workers - 2, cap * 2
            ))
        self.gate = gate
        self._httpd = _HttpServer(("0.0.0.0", port), self._handler_class())
        self.port = self._httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def _handler_class(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            def do_POST(self):  # noqa: N802 (http.server's name)
                kind = {GET: "get", REPORT: "report"}.get(self.path)
                if kind is None:
                    self.send_error(404, "no such method")
                    return
                size = int(self.headers.get("Content-Length", "0") or 0)
                if size > MAX_MESSAGE_BYTES:
                    self.send_error(413, "message too large")
                    return
                body = self.rfile.read(size)
                try:
                    node_id = int(self.headers.get(NODE_ID_HEADER, "-1"))
                except ValueError:
                    node_id = -1
                reply = server._handle(kind, body, node_id)
                if reply is None:
                    self.send_error(500, f"{kind} failed")
                    return
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(reply)))
                self.end_headers()
                self.wfile.write(reply)

            def log_message(self, *args):
                pass  # one line a request would flood the master's log

        return Handler

    def _handle(self, kind: str, request: bytes, node_id: int
                ) -> Optional[bytes]:
        """The reply bytes, or None for a handler that raised."""
        if not self.gate.try_enter(kind, node_id):
            return serialize(self.gate.overload_reply(kind))
        try:
            message = deserialize(request)
            fn = self._servicer.get if kind == "get" else self._servicer.report
            resp = fn(message, None)
            return serialize(resp) if resp is not None else b""
        except UnknownMessageError as e:
            # a newer client's request on an older master: the same typed
            # SimpleResponse the servicer's unknown-handler path returns
            return serialize(_skew_reply(e))
        except Exception:
            logger.exception("error handling %s RPC", kind)
            return None
        finally:
            self.gate.leave(kind)

    def start(self):
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="rpc-server", daemon=True
        )
        self._thread.start()

    def stop(self, grace: Optional[float] = None):
        """Stop serving; ``grace`` bounds the wait for the serving thread
        (requests in flight finish on their own daemon threads). A server
        that never started only closes its socket: ``shutdown`` would wait
        for a serving loop that never ran."""
        if self._thread is not None:
            self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(grace)


class RpcClient:
    """Client side of the two methods, with the unified retry policy.
    Each call opens its own connection (the server closes it after the
    reply), so a client is safe to share between threads and survives a
    master relaunch with nothing to rebuild."""

    def __init__(
        self,
        addr: str,
        timeout: float = 30.0,
        policy: rpc_policy.BackoffPolicy = rpc_policy.DEFAULT_RPC,
        rng: Optional[random.Random] = None,
        node_id: int = -1,
    ):
        self.addr = addr
        host, _, port = addr.rpartition(":")
        self._host = host or "127.0.0.1"
        self._port = int(port)
        self._timeout = timeout
        self._policy = policy
        self._rng = rng
        # the cheap node-id header rides every call so the server's
        # admission gate knows who it shed (-1 = anonymous caller)
        self._headers = {"Content-Type": "application/json"}
        if node_id >= 0:
            self._headers[NODE_ID_HEADER] = str(int(node_id))

    def available(self, timeout: float = 5.0) -> bool:
        """Whether the master accepts connections within ``timeout``."""
        deadline = time.time() + timeout
        while True:
            try:
                with socket.create_connection(
                    (self._host, self._port),
                    timeout=max(0.1, deadline - time.time()),
                ):
                    return True
            except OSError:
                if time.time() >= deadline:
                    return False
                time.sleep(0.1)

    def _post(self, path: str, payload: bytes, timeout: float) -> bytes:
        conn = http.client.HTTPConnection(self._host, self._port,
                                          timeout=timeout)
        try:
            conn.request("POST", path, body=payload, headers=self._headers)
            resp = conn.getresponse()
            body = resp.read()
        except http.client.HTTPException as e:
            # a reply cut off mid-way: the master went down under it
            raise ConnectionError(f"{self.addr}{path}: {e!r}") from e
        finally:
            conn.close()
        if resp.status != 200:
            raise RpcError(
                "INTERNAL" if resp.status >= 500 else "INVALID_ARGUMENT",
                f"HTTP {resp.status} from {self.addr}{path}",
            )
        return body

    def _call(
        self,
        kind: str,
        msg_: Any,
        retries: int,
        timeout: Optional[float],
        on_overload: str = "retry",
        policy: Optional[rpc_policy.BackoffPolicy] = None,
    ):
        """One logical call. ``retries`` bounds attempts; delays come from
        the policy's jittered, budget-bounded schedule. ``on_overload``:
        "retry" sleeps at least the server's hint and tries again; "raise"
        surfaces :class:`OverloadedError` at once, for periodic reporters
        that honor it by widening their cadence."""
        timeout = timeout or self._timeout
        pol = dataclasses.replace(
            policy or self._policy, max_attempts=max(1, retries)
        )
        delays = pol.delays(self._rng)
        payload = serialize(msg_)
        path = GET if kind == "get" else REPORT
        err: Optional[BaseException] = None
        while True:
            hint = 0.0
            try:
                try:
                    resp = deserialize(self._post(path, payload, timeout))
                except UnknownMessageError as e:
                    # version skew: never retried, the peer is healthy
                    raise rpc_policy.UnknownMessageTypeError(
                        e.type_name, peer=self.addr
                    ) from e
                if isinstance(resp, msg.OverloadedResponse):
                    err = OverloadedError(
                        resp.retry_after_s,
                        resp.queue_depth,
                        resp.max_interval_s,
                    )
                    if on_overload == "raise":
                        raise err
                    hint = resp.retry_after_s
                else:
                    return resp
            except OverloadedError:
                raise
            except (RpcError, OSError) as e:
                if rpc_policy.classify(e) not in rpc_policy.RETRYABLE:
                    raise
                err = e
            delay = next(delays, None)
            if delay is None:
                raise err
            time.sleep(max(delay, hint))

    def get(
        self,
        msg_: Any,
        retries: int = 3,
        timeout: Optional[float] = None,
        on_overload: str = "retry",
        policy: Optional[rpc_policy.BackoffPolicy] = None,
    ):
        return self._call("get", msg_, retries, timeout, on_overload, policy)

    def report(
        self,
        msg_: Any,
        retries: int = 3,
        timeout: Optional[float] = None,
        on_overload: str = "retry",
        policy: Optional[rpc_policy.BackoffPolicy] = None,
    ):
        return self._call("report", msg_, retries, timeout, on_overload,
                          policy)

    def close(self):
        pass  # no connection outlives a call


def _skew_reply(e: UnknownMessageError):
    """The server half of unknown-message degradation: a typed
    SimpleResponse naming the unknown ``_t``, the same shape as the
    servicer's no-handler reply."""
    logger.warning(
        "request carried unknown message type %r (version skew); "
        "answering SimpleResponse", e.type_name,
    )
    return msg.SimpleResponse(
        success=False,
        reason=f"unknown message type {e.type_name!r} (version skew)",
    )

