"""Stand-ins for the reference's names that the port does not offer yet:
each raises ``NotImplementedError`` naming the ROADMAP item that ports it,
when called or when one of its attributes is read, and carries
``__not_ported__`` so the API coverage count leaves it out."""
from __future__ import annotations

__all__ = ["not_ported"]


class _NotPorted:
    __not_ported__ = True

    def __init__(self, name: str, item: str):
        self.__name__ = name
        self._item = item

    def _raise(self):
        raise NotImplementedError(
            f"{self.__name__} is not ported yet: it waits for ROADMAP "
            f"queue 1 {self._item}")

    def __call__(self, *args, **kwargs):
        self._raise()

    def __getattr__(self, attr):
        if attr.startswith("__"):
            raise AttributeError(attr)
        self._raise()

    def __repr__(self):
        return f"<not ported: {self.__name__} ({self._item})>"


def not_ported(name: str, item: str) -> _NotPorted:
    return _NotPorted(name, item)
