"""m2n transports between coupling participants.

The reference couples two OS processes over TCP sockets
(precice_config.xml:30, ``m2n:sockets``). Two transports are provided:

- :class:`SocketTransport` — length-prefixed pickled messages over TCP;
  the *second* participant of the scheme acts as the accepting side.
- :class:`InProcessTransport` — queue pair for same-process participants
  (threads), used by the self-contained FSI demo and tests.

A copy of ``fem_shell_tpu/coupling/m2n.py``: the two packages' peers speak
the same protocol.
"""
from __future__ import annotations

import pickle
import queue
import socket
import struct
import time
from typing import Any, Tuple

_LEN = struct.Struct("!Q")


class Transport:
    def send(self, obj: Any) -> None:  # pragma: no cover - interface
        raise NotImplementedError

    def recv(self) -> Any:  # pragma: no cover - interface
        raise NotImplementedError

    def close(self) -> None:
        pass


class InProcessTransport(Transport):
    def __init__(self, tx: "queue.Queue", rx: "queue.Queue"):
        self._tx = tx
        self._rx = rx

    @staticmethod
    def pair() -> Tuple["InProcessTransport", "InProcessTransport"]:
        a, b = queue.Queue(), queue.Queue()
        return InProcessTransport(a, b), InProcessTransport(b, a)

    def send(self, obj):
        self._tx.put(pickle.dumps(obj))

    def recv(self):
        return pickle.loads(self._rx.get())


class SocketTransport(Transport):
    def __init__(self, sock: socket.socket):
        self._sock = sock

    # ------------------------------------------------------------------
    @staticmethod
    def listen(host: str, port: int, timeout: float = 120.0) -> "SocketTransport":
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind((host, port))
        srv.listen(1)
        srv.settimeout(timeout)
        conn, _ = srv.accept()
        srv.close()
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return SocketTransport(conn)

    @staticmethod
    def connect(host: str, port: int, timeout: float = 120.0) -> "SocketTransport":
        deadline = time.time() + timeout
        last = None
        while time.time() < deadline:
            try:
                s = socket.create_connection((host, port), timeout=5.0)
                s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                return SocketTransport(s)
            except OSError as e:  # peer not up yet
                last = e
                time.sleep(0.1)
        raise TimeoutError(f"could not connect to {host}:{port}: {last}")

    # ------------------------------------------------------------------
    def send(self, obj):
        payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
        self._sock.sendall(_LEN.pack(len(payload)) + payload)

    def _recv_exact(self, n: int) -> bytes:
        buf = bytearray()
        while len(buf) < n:
            chunk = self._sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("m2n peer closed the connection")
            buf.extend(chunk)
        return bytes(buf)

    def recv(self):
        (n,) = _LEN.unpack(self._recv_exact(_LEN.size))
        return pickle.loads(self._recv_exact(n))

    def close(self):
        try:
            self._sock.close()
        except OSError:
            pass
