"""Unified retry / timeout / backoff policy for the control plane: the
port's own copy of dlrover_tpu/rpc/policy.py.

- :func:`classify` — error taxonomy.  ``unavailable`` (master down /
  connection refused / mid-relaunch) and ``deadline`` (server slow or
  link black-holed) are retryable transport conditions; ``overloaded``
  is the server's *explicit* shed signal (``OverloadedResponse``)
  which callers honor by widening their own interval rather than
  hammering the retry path; ``application`` errors propagate — the
  server saw the request and rejected it, retrying is wrong.
- :class:`BackoffPolicy` — jittered exponential backoff with a
  total-sleep budget, deterministic under a seeded rng.
- :class:`AdaptiveInterval` — AIMD report cadence: widen
  multiplicatively on ``Overloaded``, decay back toward the base on
  success, used by the agent's folded status reporter.
"""

from __future__ import annotations

import dataclasses
import random
import threading
from typing import Iterator, Optional

# -- error taxonomy ---------------------------------------------------------

UNAVAILABLE = "unavailable"
DEADLINE = "deadline"
OVERLOADED = "overloaded"
APPLICATION = "application"


class OverloadedError(Exception):
    """The server shed this request (explicit backpressure).

    Carries the server's ``retry_after_s`` hint; periodic reporters
    honor it by widening their interval instead of retrying."""

    def __init__(
        self,
        retry_after_s: float = 0.0,
        queue_depth: int = 0,
        max_interval_s: float = 0.0,
    ):
        self.retry_after_s = max(0.0, float(retry_after_s))
        self.queue_depth = int(queue_depth)
        #: server-advertised liveness ceiling: widening past this gets
        #: the client evicted by the heartbeat monitor (0 = unknown)
        self.max_interval_s = max(0.0, float(max_interval_s))
        super().__init__(
            f"server overloaded (queue_depth={queue_depth}, "
            f"retry_after={self.retry_after_s:.2f}s)"
        )


class UnknownMessageTypeError(Exception):
    """The peer answered with a message type this binary cannot decode
    (``serde.UnknownMessageError`` mapped into the taxonomy by
    ``RpcClient._call``).

    This is version skew, not a transport blip: retrying replays the
    same decode failure, so it classifies ``application`` (never
    retried) and the message is actionable — it names the unknown
    ``_t`` and the rollout rule. Before this class existed the raw
    ``ValueError`` escaped the retry loop and surfaced at whatever call
    site happened to touch the response first (the documented
    OverloadedResponse hazard: a pre-gate client saw shed load as an
    AttributeError/ValueError instead of backpressure)."""

    def __init__(self, type_name: str, peer: str = ""):
        self.type_name = str(type_name)
        self.peer = str(peer)
        where = f" from {self.peer}" if self.peer else ""
        super().__init__(
            f"peer{where} sent unknown message type {self.type_name!r} — "
            "version skew between this binary and the peer; align "
            "versions, and upgrade masters LAST so old clients keep "
            "receiving only message types they know"
        )


def classify(exc: BaseException) -> str:
    """Map an exception to the taxonomy. Status codes are read
    duck-typed (``exc.code().name``, gRPC's names), so the port's HTTP
    transport (``transport.RpcError``) classifies as the JAX package's
    gRPC one does."""
    if isinstance(exc, OverloadedError):
        return OVERLOADED
    if isinstance(exc, UnknownMessageTypeError):
        # version skew: the peer is healthy and reachable, retrying
        # replays the identical decode failure
        return APPLICATION
    code = None
    code_fn = getattr(exc, "code", None)
    if callable(code_fn):
        try:
            code = code_fn()
        except Exception:
            code = None
    name = getattr(code, "name", "")
    if name in ("UNAVAILABLE", "CANCELLED", "UNKNOWN"):
        # UNKNOWN: a server that died mid-handler surfaces as UNKNOWN on
        # some grpc versions; treat like a transport blip
        return UNAVAILABLE
    if name == "DEADLINE_EXCEEDED":
        return DEADLINE
    if name == "RESOURCE_EXHAUSTED":
        return OVERLOADED
    if name:
        return APPLICATION
    if isinstance(exc, (ConnectionError, TimeoutError, OSError)):
        return UNAVAILABLE
    return APPLICATION


RETRYABLE = frozenset({UNAVAILABLE, DEADLINE, OVERLOADED})


# -- jittered exponential backoff ------------------------------------------


@dataclasses.dataclass(frozen=True)
class BackoffPolicy:
    """Jittered exponential backoff shape.

    ``jitter`` is the +/- fraction applied to each delay (0.2 → each
    sleep lands uniformly in [0.8d, 1.2d]); a fleet of clients with the
    same policy therefore de-phases instead of thundering together.
    ``budget_s`` bounds the *total* sleep across one logical call —
    attempts stop when spending the next delay would exceed it."""

    base_s: float = 0.1
    multiplier: float = 2.0
    max_s: float = 8.0
    jitter: float = 0.2
    budget_s: float = 60.0
    max_attempts: int = 8

    def delays(self, rng: Optional[random.Random] = None) -> Iterator[float]:
        """The delay sequence (jittered, budget-bounded). Yields at most
        ``max_attempts - 1`` delays: one fewer sleep than attempts."""
        rnd = rng or random
        spent = 0.0
        delay = self.base_s
        for _ in range(max(0, self.max_attempts - 1)):
            d = min(delay, self.max_s)
            if self.jitter > 0.0:
                d *= 1.0 + self.jitter * (2.0 * rnd.random() - 1.0)
            d = max(0.0, d)
            if spent + d > self.budget_s:
                return
            spent += d
            yield d
            delay *= self.multiplier


#: client-side default for master RPCs — the same 1, 2, 4, 8… ladder
#: the pre-policy transport slept (now jittered): a default-retries
#: call must keep riding out the multi-second master blips it always
#: did, so the base must NOT be made snappier without auditing every
#: call site's relaunch tolerance
DEFAULT_RPC = BackoffPolicy(base_s=1.0)

#: rides out a master relaunch (~20s+ of cumulative sleep)
RELAUNCH_TOLERANT = BackoffPolicy(
    base_s=0.5, multiplier=2.0, max_s=10.0, budget_s=120.0, max_attempts=12
)

#: polling loops (barrier / rendezvous world / num_nodes_waiting):
#: start fast for snappy small jobs, widen so 1k waiters don't
#: synchronize — max_attempts unbounded-ish, the caller's deadline
#: terminates the loop
POLL = BackoffPolicy(
    base_s=0.1, multiplier=1.5, max_s=2.0, jitter=0.5,
    budget_s=float("inf"), max_attempts=1_000_000,
)


def poll_intervals(
    policy: BackoffPolicy = POLL, rng: Optional[random.Random] = None
) -> Iterator[float]:
    """Jittered, growing poll intervals for wait-until loops. Unlike
    :meth:`BackoffPolicy.delays` this never exhausts — after the growth
    phase it keeps yielding jittered ``max_s`` — because poll loops are
    bounded by the caller's deadline, not by attempt count."""
    rnd = rng or random
    delay = policy.base_s
    while True:
        d = min(delay, policy.max_s)
        if policy.jitter > 0.0:
            d *= 1.0 + policy.jitter * (2.0 * rnd.random() - 1.0)
        yield max(0.0, d)
        delay *= policy.multiplier


# -- AIMD report cadence ----------------------------------------------------


class AdaptiveInterval:
    """Additive-decrease / multiplicative-increase report interval.

    ``widen()`` on an ``Overloaded`` reply (or an unreachable master)
    multiplies the interval up to ``max_s``; ``ok()`` on a served
    report decays it back toward ``base_s`` by ``recovery`` per report.
    The asymmetry is deliberate: overload must shed load *now*, while
    recovery creeping back spreads the fleet's return over many report
    periods instead of snapping 1k workers back to the fast cadence in
    the same second. Thread-safe (reporter thread + monitor callbacks).
    """

    def __init__(
        self,
        base_s: float,
        max_s: Optional[float] = None,
        factor: float = 2.0,
        recovery: float = 0.8,
        jitter: float = 0.25,
    ):
        self.base_s = float(base_s)
        self.max_s = float(max_s) if max_s is not None else self.base_s * 16
        self.factor = float(factor)
        self.recovery = float(recovery)
        self.jitter = float(jitter)
        self._lock = threading.Lock()
        self._current = self.base_s

    def next_delay_s(self, rng: Optional[random.Random] = None) -> float:
        """The jittered wait until the next report. The jitter is NOT
        cosmetic: an overload widens many workers in the same instant,
        and un-jittered AIMD phase-locks them into cohorts that pound
        the admission gate in the same beat forever — the same unlucky
        members get shed every round until the heartbeat evictor
        declares live workers dead (found by the fleet chaos harness's
        overload scenario)."""
        rnd = rng or random
        with self._lock:
            d = self._current
        if self.jitter > 0.0:
            d *= 1.0 + self.jitter * (2.0 * rnd.random() - 1.0)
        return max(0.0, d)

    def widen(self, hint_s: float = 0.0, ceiling_s: float = 0.0) -> float:
        """Overload signal: jump to max(current*factor, server hint),
        bounded by ``ceiling_s`` when the server advertised its
        liveness ceiling (``OverloadedResponse.max_interval_s``) —
        backing off must never back the client into an eviction."""
        cap = self.max_s
        if ceiling_s > 0.0:
            cap = min(cap, ceiling_s)
        with self._lock:
            target = min(cap, max(self._current * self.factor, hint_s))
            # monotonic under overload: a liveness ceiling BELOW the
            # current cadence must freeze widening, never SPEED THE
            # CLIENT UP (min() alone would shrink the interval under
            # load and amplify the overload)
            self._current = max(self._current, target)
            return self._current

    def ok(self) -> float:
        """Served report: geometric decay back toward the base."""
        with self._lock:
            if self._current > self.base_s:
                self._current = max(
                    self.base_s, self._current * self.recovery
                )
            return self._current
