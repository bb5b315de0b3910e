"""Stand-ins for the names of ``paddle_tpu.distributed`` that wait for
ROADMAP queue 1 item 5c, part 2 (pipeline parallelism, ZeRO, DGC/LocalSGD,
auto_parallel, rpc, the fleet's data generators and elastic manager): each
raises ``NotImplementedError`` naming that item when called, instantiated
or read from, and carries ``__not_ported__``."""
from __future__ import annotations

__all__ = ["part2", "PART2"]

PART2 = "ROADMAP queue 1 item 5c, part 2"


class _Part2:
    __not_ported__ = True

    def __init__(self, name: str):
        object.__setattr__(self, "_name", name)

    def _raise(self):
        raise NotImplementedError(
            f"paddle.distributed {self._name} waits for {PART2}")

    def __call__(self, *args, **kwargs):
        self._raise()

    def __getattr__(self, attr):
        if attr.startswith("__") and attr.endswith("__"):
            raise AttributeError(attr)
        self._raise()

    def __repr__(self):
        return f"<{self._name}: waits for {PART2}>"


def part2(name: str) -> _Part2:
    return _Part2(name)
