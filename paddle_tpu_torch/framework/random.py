"""The port's random state: the counterpart of
``paddle_tpu/framework/random.py`` (``Generator``, ``seed``,
``default_generator``, ``get_rng_state``/``set_rng_state``).

The reference keeps one stateful generator that splits a JAX key for every
random op. The port keeps one ``torch.Generator`` per device inside a
:class:`Generator`, all seeded with the same seed, and its random ops
(``nn.functional.dropout``, the dense attention's probability dropout) draw
from the generator of the device their tensor lies on, never from torch's
global stream. ``get_state``/``set_state`` carry every device's stream, so a
run saved and resumed (``framework/io.py``) draws the same numbers after the
resume as an uninterrupted run does. The two packages' streams differ: tests
feed both the same masks, or compare distributions.
"""
from __future__ import annotations

import threading
from typing import Dict, Optional

import numpy as np
import torch

__all__ = ["Generator", "seed", "default_generator", "get_rng_state",
           "set_rng_state", "fresh_default_generator"]


def _device_key(device) -> str:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return str(dev)


class Generator:
    """Explicit random state over every device: ``for_device(device)`` is
    the ``torch.Generator`` of that device, created at first use and seeded
    with this generator's seed."""

    def __init__(self, seed: int = 0):
        self._lock = threading.Lock()
        self._gens: Dict[str, torch.Generator] = {}
        self.manual_seed(seed)

    def manual_seed(self, seed: int) -> "Generator":
        """Reseed every device's stream (streams not yet created start from
        ``seed`` too)."""
        with self._lock:
            self._seed = int(seed)
            for g in self._gens.values():
                g.manual_seed(self._seed)
        return self

    def initial_seed(self) -> int:
        return self._seed

    def for_device(self, device) -> torch.Generator:
        key = _device_key(device)
        with self._lock:
            g = self._gens.get(key)
            if g is None:
                g = torch.Generator(device=key)
                g.manual_seed(self._seed)
                self._gens[key] = g
            return g

    def get_state(self) -> dict:
        """``{"seed": int, "states": {device: uint8 tensor}}``: every
        created device stream's position (a copy)."""
        with self._lock:
            return {"seed": self._seed,
                    "states": {k: g.get_state().clone()
                               for k, g in self._gens.items()}}

    def set_state(self, state: dict) -> None:
        """Restore :meth:`get_state`'s result (tensors or arrays)."""
        self.manual_seed(int(state["seed"]))
        for key, st in state["states"].items():
            self.for_device(key).set_state(
                torch.as_tensor(np.asarray(st), dtype=torch.uint8).cpu())


# Made at first use, from numpy's global stream as the reference does
# (np.random.randint), so that importing the package draws nothing.
_default: Optional[Generator] = None
_default_lock = threading.Lock()


def default_generator() -> Generator:
    global _default
    with _default_lock:
        if _default is None:
            _default = Generator(seed=np.random.randint(0, 2 ** 31 - 1))
        return _default


def seed(s: int) -> Generator:
    """``paddle.seed``: reseed the default generator; returns it."""
    return default_generator().manual_seed(s)


def fresh_default_generator(s: int) -> Generator:
    """Replace the default generator with a new one seeded with ``s``,
    without touching the old one's device streams: a forked DataLoader
    worker must not use the CUDA streams it inherited (CUDA cannot be
    re-initialised in a forked child)."""
    global _default
    with _default_lock:
        _default = Generator(seed=s)
        return _default


def get_rng_state() -> list:
    return [default_generator().get_state()]


def set_rng_state(states) -> None:
    default_generator().set_state(states[0])
