"""Cross-host checkpoint replicas (port of dlrover_tpu/checkpoint/replica.py,
on the same wire).

The agent-resident saver streams this node's staged shm segments to a
backup peer's saver over TCP, off the training processes' path, and a
replacement host pulls its seat's segments back before its workers
restart, so they restore from host memory instead of storage.

Placement: the backup of node rank ``r`` lives on ``(r + 1) % world``, so a
restored host knows whom to ask. Wire: a little-endian u64 length, a JSON
header of that length (``op``, ``token``, ``owner_rank``, ``size``...),
then ``size`` payload bytes.
"""

from __future__ import annotations

import json
import socket
import struct
import threading
from typing import Dict, List, Optional, Tuple

from dlrover_tpu_torch.checkpoint.shm_handler import (
    HEADER_SPACE,
    SharedMemoryHandler,
)
from dlrover_tpu_torch.common import flags
from dlrover_tpu_torch.common.log import logger

_CHUNK = 1 << 20
_HDR_FMT = "<Q"  # length-prefixed JSON header
_MAX_HEADER = 16 << 20


def max_payload_bytes() -> int:
    """The largest payload a server buffers (a memory-DoS bound)."""
    return int(flags.REPLICA_MAX_BYTES.get())


def _send_msg(sock: socket.socket, header: Dict, payload: bytes = b""):
    raw = json.dumps(header).encode()
    sock.sendall(struct.pack(_HDR_FMT, len(raw)))
    sock.sendall(raw)
    if payload:
        sock.sendall(payload)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    out = bytearray(n)
    view = memoryview(out)
    got = 0
    while got < n:
        k = sock.recv_into(view[got:], min(_CHUNK, n - got))
        if not k:
            raise ConnectionError("peer closed mid-message")
        got += k
    return bytes(out)


def _recv_header(sock: socket.socket) -> Dict:
    (hlen,) = struct.unpack(_HDR_FMT, _recv_exact(sock, 8))
    if hlen > _MAX_HEADER:
        raise ConnectionError(f"oversized header ({hlen} bytes)")
    return json.loads(_recv_exact(sock, hlen).decode())


def _recv_msg(sock: socket.socket) -> Tuple[Dict, bytes]:
    header = _recv_header(sock)
    size = int(header.get("size", 0))
    if size > max_payload_bytes():
        raise ConnectionError(f"oversized payload ({size} bytes)")
    return header, _recv_exact(sock, size)


class ReplicaServer:
    """Peers' staged segments in memory, one slot an owner rank (the
    latest step wins).

    Every request must carry the job's replica token; until one is set,
    every request is refused: the server is reachable from other hosts by
    necessity, unlike the node-local unix socket."""

    def __init__(self, port: int = 0):
        self._store: Dict[int, Tuple[int, List[Dict], bytes]] = {}
        self._lock = threading.Lock()
        self._token = ""
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind(("0.0.0.0", port))
        self._sock.listen(8)
        self.port = self._sock.getsockname()[1]
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._serve, name="ckpt-replica", daemon=True)
        self._thread.start()

    def set_token(self, token: str):
        self._token = token

    def stop(self):
        self._stop.set()
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._sock.close()

    def stored_steps(self) -> Dict[int, int]:
        with self._lock:
            return {rank: v[0] for rank, v in self._store.items()}

    def _serve(self):
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            threading.Thread(target=self._handle, args=(conn,),
                             daemon=True).start()

    def _handle(self, conn: socket.socket):
        try:
            with conn:
                header = _recv_header(conn)
                size = int(header.get("size", 0))
                if not self._token or header.get("token") != self._token:
                    # refused before the payload is buffered
                    _send_msg(conn, {"ok": False, "error": "unauthorized"})
                    return
                if size > max_payload_bytes():
                    _send_msg(conn, {"ok": False, "error": "too large"})
                    return
                payload = _recv_exact(conn, size)
                op = header.get("op")
                if op == "put":
                    owner = int(header["owner_rank"])
                    step = int(header["step"])
                    with self._lock:
                        have = self._store.get(owner)
                        if have is None or have[0] <= step:
                            self._store[owner] = (step, header["segments"],
                                                  payload)
                    _send_msg(conn, {"ok": True})
                elif op == "get":
                    with self._lock:
                        have = self._store.get(int(header["owner_rank"]))
                    if have is None:
                        _send_msg(conn, {"ok": False})
                    else:
                        step, segments, payload = have
                        _send_msg(conn, {"ok": True, "step": step,
                                         "segments": segments,
                                         "size": len(payload)}, payload)
                elif op == "drop":
                    with self._lock:
                        self._store.pop(int(header["owner_rank"]), None)
                    _send_msg(conn, {"ok": True})
                else:
                    _send_msg(conn, {"ok": False, "error": "bad op"})
        except (ConnectionError, json.JSONDecodeError, KeyError,
                OSError) as e:
            logger.warning("replica request failed: %s", e)


def _rpc(addr: Tuple[str, int], header: Dict, payload: bytes = b"",
         timeout: float = 60.0) -> Tuple[Dict, bytes]:
    with socket.create_connection(addr, timeout=timeout) as sock:
        _send_msg(sock, header, payload)
        return _recv_msg(sock)


class ReplicaManager:
    """The saver's side: push this node's segments to the backup peer, pull
    them back after a relaunch."""

    def __init__(self, server: Optional[ReplicaServer] = None):
        self.server = server or ReplicaServer()
        self._peers: Dict[int, Tuple[str, int]] = {}  # rank -> (ip, port)
        self._self_rank = 0
        self._world = 1
        self._token = ""
        self._lock = threading.Lock()
        self.last_pushed_step = -1

    @property
    def port(self) -> int:
        return self.server.port

    def set_token(self, token: str):
        self._token = token
        self.server.set_token(token)

    def update_peers(self, peers: Dict[int, Tuple[str, int]], self_rank: int,
                     world: int):
        with self._lock:
            self._peers = dict(peers)
            self._self_rank = self_rank
            self._world = max(1, world)

    def _backup_peer(self) -> Optional[Tuple[str, int]]:
        """``(r + 1) % world``: where this rank's backup goes, and so where
        a restore of this seat asks."""
        with self._lock:
            if self._world < 2:
                return None
            return self._peers.get((self._self_rank + 1) % self._world)

    # -- backup -------------------------------------------------------------

    @staticmethod
    def _segment_payload(handler: SharedMemoryHandler
                         ) -> Optional[Tuple[Dict, bytes]]:
        meta = handler.read_meta()
        if meta is None:
            return None
        used = HEADER_SPACE
        for leaf in meta.leaves:
            used = max(used, leaf.offset + leaf.nbytes)
        data = bytes(handler.buf[:used])
        return ({"size": len(data), "step": meta.step,
                 "process_id": meta.process_id}, data)

    def collect_segments(self, handlers: List[SharedMemoryHandler]
                         ) -> Optional[Tuple[int, List[Dict], bytes]]:
        """Copy the staged segments out of shm (call under the shm lock;
        the heap copy lets the transfer run without it)."""
        segments, blobs, step = [], [], -1
        for h in handlers:
            if not h.attach():
                continue
            seg = self._segment_payload(h)
            if seg is None:
                continue
            segments.append(seg[0])
            blobs.append(seg[1])
            step = max(step, seg[0]["step"])
        if not segments:
            return None
        return step, segments, b"".join(blobs)

    def send_backup(self, step: int, segments: List[Dict],
                    payload: bytes) -> bool:
        """Stream a collected snapshot to the backup peer (no lock held)."""
        peer = self._backup_peer()
        if peer is None:
            return False
        try:
            resp, _ = _rpc(peer, {
                "op": "put", "token": self._token,
                "owner_rank": self._self_rank, "step": step,
                "segments": segments, "size": len(payload),
            }, payload)
        except OSError as e:
            logger.warning("replica push to %s failed: %s", peer, e)
            return False
        ok = bool(resp.get("ok"))
        if ok:
            self.last_pushed_step = max(self.last_pushed_step, step)
            logger.info("replicated step %s (%.1f MB) to backup peer %s",
                        step, len(payload) / 1e6, peer)
        return ok

    def push_backup(self, handlers: List[SharedMemoryHandler]) -> bool:
        """Collect and send in one call, for callers that hold no lock."""
        snapshot = self.collect_segments(handlers)
        if snapshot is None:
            return False
        return self.send_backup(*snapshot)

    # -- restore ------------------------------------------------------------

    def fetch_backup_into_shm(self, target_names: List[str]) -> int:
        """Pull this seat's segments from the backup peer and write them
        as shm segments under ``target_names`` (this node's names, one a
        local process, in local-rank order). The segments carry the dead
        host's process ids, so they map onto the targets in process-id
        order. Returns the restored step, or -1."""
        peer = self._backup_peer()
        if peer is None or not target_names:
            return -1
        try:
            resp, payload = _rpc(peer, {"op": "get", "token": self._token,
                                        "owner_rank": self._self_rank})
        except OSError as e:
            logger.warning("replica fetch from %s failed: %s", peer, e)
            return -1
        if not resp.get("ok"):
            return -1
        segments = resp["segments"]
        if len(segments) != len(target_names):
            logger.warning("backup has %s segments but this node runs %s "
                           "processes; skipping the replica restore",
                           len(segments), len(target_names))
            return -1
        order = sorted(range(len(segments)),
                       key=lambda i: segments[i]["process_id"])
        offsets, off = [], 0
        for seg in segments:
            offsets.append(off)
            off += seg["size"]
        view = memoryview(payload)
        for target, i in zip(target_names, order):
            handler = SharedMemoryHandler(target, create=True)
            try:
                handler.restore_segment(
                    view[offsets[i]:offsets[i] + segments[i]["size"]])
            finally:
                handler.close()
        logger.info("restored step %s staged state from backup peer %s",
                    resp["step"], peer)
        return int(resp["step"])
