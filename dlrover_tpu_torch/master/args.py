"""Master CLI arguments: the port's own copy of dlrover_tpu/master/args.py
(``--platform local`` only; the k8s master waits for ``dist_master``)."""

from __future__ import annotations

import argparse


def build_master_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("dlrover_tpu_torch master")
    p.add_argument("--platform", default="local", choices=["local"])
    p.add_argument("--port", type=int, default=0, help="port (0 = auto)")
    p.add_argument("--node_num", type=int, default=1)
    p.add_argument(
        "--heartbeat_timeout", type=float, default=600,
        help="seconds without heartbeat before a node is declared dead",
    )
    p.add_argument(
        "--port_file",
        default="",
        help="write the bound port to this file (standalone handshake)",
    )
    return p


def parse_master_args(argv=None):
    return build_master_parser().parse_args(argv)
