"""``ShmRing``: the ctypes wrapper over the port's shared-memory ring
(``csrc/host/shm_ring.cc``; counterpart of ``paddle_tpu/native/shm_ring.py``).
Single producer, single consumer per ring; the DataLoader gives each worker
its own."""
from __future__ import annotations

import ctypes

from . import host_library

__all__ = ["ShmRing"]


class ShmRing:
    """A ring of ``n_slots`` slots of ``slot_bytes`` bytes under the POSIX
    shared-memory ``name``: created by its owner (the trainer), opened by
    name in the worker. ``push`` returns False for a payload larger than a
    slot (the caller sends it another way); a closed ring raises
    ``BrokenPipeError``."""

    def __init__(self, name: str, owner: bool, n_slots: int = 4,
                 slot_bytes: int = 8 << 20):
        self._l = host_library()
        self._h = self._l.shm_ring_open(name.encode(), 1 if owner else 0,
                                        n_slots, slot_bytes)
        if not self._h:
            raise OSError(f"shm_ring_open({name!r}, owner={owner}) failed")
        self.name = name
        self.slot_bytes = slot_bytes

    @property
    def payload_capacity(self) -> int:
        return self.slot_bytes - 8

    def push(self, data: bytes) -> bool:
        rc = self._l.shm_ring_push(self._h, data, len(data))
        if rc == -2:
            return False
        if rc == -1:
            raise BrokenPipeError(f"shm ring {self.name} closed")
        return True

    def pop(self, timeout_ms: int = -1) -> bytes:
        buf = ctypes.create_string_buffer(self.slot_bytes)
        n = self._l.shm_ring_pop(self._h, buf, self.slot_bytes, timeout_ms)
        if n == -1:
            raise BrokenPipeError(f"shm ring {self.name} closed")
        if n == -3:
            raise TimeoutError(f"shm ring {self.name}: pop timed out")
        if n < 0:
            raise RuntimeError(f"shm_ring_pop error {n}")
        return buf.raw[:n]

    def close(self) -> None:
        """Mark the ring closed: a blocked push or an empty pop returns."""
        if self._h:
            self._l.shm_ring_close(self._h)

    def free(self) -> None:
        """Unmap the ring (the owner also unlinks its name)."""
        if self._h:
            self._l.shm_ring_free(self._h)
            self._h = None
