"""Typed flag registry: only the ``FLAGS_decode_*`` knobs the generation
engine reads.

Counterpart of ``paddle_tpu/framework/flags.py`` (same surface:
``define_flag``/``flag_value``/``set_flags``, with a
``FLAGS_*`` environment variable overriding the default at definition
time). The port keeps its own registry: it imports nothing of
``paddle_tpu``.
"""
from __future__ import annotations

import os
from typing import Any, Dict

__all__ = ["define_flag", "flag_value", "set_flags"]


class _Flag:
    __slots__ = ("name", "value", "default", "type_", "help")

    def __init__(self, name, default, help_=""):
        self.name = name
        self.default = default
        self.type_ = type(default)
        self.help = help_
        env = os.environ.get(name)
        self.value = self._parse(env) if env is not None else default

    def _parse(self, s: str):
        if self.type_ is bool:
            return s.lower() in ("1", "true", "yes", "on")
        try:
            return self.type_(s)
        except (TypeError, ValueError) as e:
            raise ValueError(
                f"flag {self.name}: cannot parse {s!r} from environment "
                f"variable {self.name} as {self.type_.__name__} "
                f"(default: {self.default!r})") from e

    def set(self, v):
        if self.type_ is bool and isinstance(v, str):
            v = self._parse(v)
        try:
            self.value = self.type_(v)
        except (TypeError, ValueError) as e:
            raise ValueError(
                f"flag {self.name}: cannot coerce {v!r} to "
                f"{self.type_.__name__} (default: {self.default!r})") from e


_REGISTRY: Dict[str, _Flag] = {}


def define_flag(name: str, default, help_: str = ""):
    if not name.startswith("FLAGS_"):
        name = "FLAGS_" + name
    if name not in _REGISTRY:
        _REGISTRY[name] = _Flag(name, default, help_)
    return _REGISTRY[name]


def _key(name: str) -> str:
    key = name if name.startswith("FLAGS_") else "FLAGS_" + name
    if key not in _REGISTRY:
        raise KeyError(f"unknown flag {name!r}")
    return key


def flag_value(name: str):
    return _REGISTRY[_key(name)].value


def set_flags(flags: Dict[str, Any]) -> None:
    for name, v in flags.items():
        _REGISTRY[_key(name)].set(v)


# Decode serving knobs (serving/generation/engine.py), with the reference's
# names and defaults. The reference's FLAGS_decode_prefix_cache and
# FLAGS_decode_spec_k wait for the prefix cache and speculative decoding.
define_flag("FLAGS_decode_max_batch", 8,
            "in-flight decode batch width: one [max_batch, 1] decode step "
            "per iteration with dead lanes slot-masked")
define_flag("FLAGS_decode_page_size", 16,
            "tokens per KV-cache page of the per-layer pools")
define_flag("FLAGS_decode_kv_pages", 0,
            "total pages per layer pool incl. the reserved trash page "
            "(0 = auto: enough for max_batch sequences at max_seq_len, "
            "doubled for sub-f32 pools)")
define_flag("FLAGS_decode_queue_capacity", 64,
            "bounded generation request queue; submit_generate raises "
            "QueueFullError beyond this")
define_flag("FLAGS_decode_default_timeout_ms", 0.0,
            "scheduling deadline applied when submit_generate passes none "
            "(0 = no deadline); an expired request is dropped before "
            "prefill, never mid-stream")
define_flag("FLAGS_decode_kv_dtype", "",
            "KV pool storage dtype: '' = model dtype, 'float32' or "
            "'bfloat16' ('int8' is not ported yet)")
