"""Worker-log failure classification: the port's own copy of
``classify_log`` and its pattern tuples from
dlrover_tpu/diagnosis/operators.py.

Every JAX pattern is kept, so a log either package's worker writes is
classified alike. Each tuple adds the torch/CUDA counterparts of its
class, and only those: a peer's death seen through a ``ProcessGroupNCCL``
or gloo connection closed by the peer, or an aborted communicator; and the
card's hardware faults, an uncorrectable ECC error, an ``Xid`` and a GPU
fallen off the bus. The inference operators that read these classes off
the master's diagnosis data wait for the diagnosis manager (ROADMAP.md).
"""

from __future__ import annotations

import re
from typing import Optional

# Failure signatures scanned from worker logs.
FATAL_PATTERNS = (
    r"Traceback \(most recent call last\)",
    r"FATAL|Fatal Python error",
    r"XlaRuntimeError",
)
# A *peer* died and the collective runtime tore this process down. The
# local host is healthy: restart and re-rendezvous. These are checked
# before HARDWARE_PATTERNS because JAX's generic peer-death message
# contains the words "preempted/died/restarted", which would otherwise read
# as a local preemption and make every surviving node exit.
PEER_FAILURE_PATTERNS = (
    r"JAX distributed service detected fatal errors",
    r"another task died",
    r"leader task was preempted",
    r"Failed to send RPC to coordination service",
    # torch.distributed: gloo's and ProcessGroupNCCL's view of a dead peer
    r"Connection closed by peer",
    r"communicator was aborted|aborted communicator",
)
RETRYABLE_PATTERNS = (
    r"RESOURCE_EXHAUSTED|out of memory|OOM",
    r"UNAVAILABLE|DEADLINE_EXCEEDED",
    r"coordination service|heartbeat",
)
HARDWARE_PATTERNS = (
    r"preempt|SIGTERM",
    r"ici link|chip failure|DATA_LOSS|hbm (ecc|parity|uncorrectable)",
    # the card's faults as the CUDA runtime and NVRM (Xid) report them
    r"uncorrectable ECC error|\bXid\b|GPU has fallen off the bus",
)


def classify_log(text: str) -> Optional[str]:
    """'hardware' | 'retryable' | 'fatal' | None from a worker log tail.

    Peer-death signatures win (the local host is fine: restart in place),
    then hardware/preemption (the node must be replaced), then transient
    retryables, then generic fatal tracebacks.
    """
    if not text:
        return None
    for pat in PEER_FAILURE_PATTERNS:
        if re.search(pat, text, re.IGNORECASE):
            return "retryable"
    for pat in HARDWARE_PATTERNS:
        if re.search(pat, text, re.IGNORECASE):
            return "hardware"
    for pat in RETRYABLE_PATTERNS:
        if re.search(pat, text, re.IGNORECASE):
            return "retryable"
    for pat in FATAL_PATTERNS:
        if re.search(pat, text):
            return "fatal"
    return None
