"""Small network helpers: the port's own copy of dlrover_tpu/utils/net.py.

``local_ip`` differs on purpose: the JAX helper resolves the host name and
probes a route to a public address; the port's makes no lookup and sends
nothing, and takes this node's address from ``DLROVER_TPU_NODE_IP``, else
the loopback. That is the whole world of a standalone job; a job that
spans hosts sets the variable on each of them.
"""

from __future__ import annotations

import socket
from contextlib import closing


def find_free_port(host: str = "") -> int:
    with closing(socket.socket(socket.AF_INET, socket.SOCK_STREAM)) as s:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind((host, 0))
        return s.getsockname()[1]


def local_ip() -> str:
    """This node's advertised IP: ``DLROVER_TPU_NODE_IP``, else loopback."""
    from dlrover_tpu_torch.common import flags

    return flags.NODE_IP.get() or "127.0.0.1"
