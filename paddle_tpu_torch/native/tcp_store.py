"""TCPStore: the port of ``paddle_tpu/native/tcp_store.py``, over
``torch.distributed.TCPStore`` (c10d's key-value store, which also carries
the process group's own rendezvous).

The reference's API: rank 0 hosts the master (``TCPStoreServer``, or
``TCPStore(is_master=True)``), every rank gets ``set``/``get``/``add``/
``wait``/``delete``/``barrier``; ``get`` of a missing key raises
``KeyError`` at once and ``wait`` raises ``TimeoutError``. The reference's
timeouts: 30 s to connect and to wait, 60 s for a barrier.
"""
from __future__ import annotations

import datetime
from typing import Optional, Union

__all__ = ["TCPStoreServer", "TCPStore"]


def _td(seconds: float) -> datetime.timedelta:
    return datetime.timedelta(seconds=float(seconds))


class TCPStoreServer:
    """The master store, listening on ``port`` (0: a free port, read back
    as ``.port``)."""

    def __init__(self, port: int = 0, timeout: float = 30.0):
        import torch.distributed as dist
        self._store = dist.TCPStore("127.0.0.1", int(port), is_master=True,
                                    wait_for_workers=False,
                                    timeout=_td(timeout))
        self.port = int(self._store.port)

    def stop(self):
        self._store = None


class TCPStore:
    """A client; ``is_master`` hosts the server in this process (rank 0).
    ``raw`` is the underlying ``torch.distributed.Store``, which the
    process group is built on."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 is_master: bool = False, timeout: float = 30.0,
                 world_size: Optional[int] = None):
        import torch.distributed as dist
        self.timeout = float(timeout)
        if is_master:
            self.server = TCPStoreServer(port, timeout)
            self.raw = self.server._store
        else:
            self.server = None
            try:
                self.raw = dist.TCPStore(host, int(port), is_master=False,
                                         timeout=_td(timeout))
            except Exception as e:  # noqa: BLE001 - c10d's own error types
                raise TimeoutError(
                    f"TCPStore connect to {host}:{port} timed out") from e
        self.host = host
        self.port = self.server.port if self.server else int(port)

    @staticmethod
    def _bytes(value: Union[str, bytes]) -> bytes:
        return value.encode() if isinstance(value, str) else bytes(value)

    def set(self, key: str, value):
        self.raw.set(key, self._bytes(value))

    def get(self, key: str) -> bytes:
        if not self.raw.check([key]):
            raise KeyError(key)
        return bytes(self.raw.get(key))

    def delete(self, key: str):
        self.raw.delete_key(key)

    def add(self, key: str, delta: int = 1) -> int:
        return int(self.raw.add(key, int(delta)))

    def wait(self, key: str, timeout: float = 30.0) -> bytes:
        try:
            self.raw.wait([key], _td(timeout))
        except Exception as e:  # noqa: BLE001 - DistStoreError on timeout
            raise TimeoutError(f"TCPStore.wait({key}) timed out") from e
        return bytes(self.raw.get(key))

    def barrier(self, name: str, world_size: int, timeout: float = 60.0):
        n = self.add(f"__barrier/{name}", 1)
        if n == world_size:
            self.set(f"__barrier/{name}/done", b"1")
        self.wait(f"__barrier/{name}/done", timeout)

    def close(self):
        self.raw = None
        if self.server is not None:
            self.server.stop()
            self.server = None
