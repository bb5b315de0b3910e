"""Prefill/decode steps over a cache-capable causal LM (the port of
``paddle_tpu/serving/generation/model_fns.py``).

``CachedDecoder`` exposes the device entry points of the decode engine:

- ``prefill(ids, prompt_lens, tables, k, v)`` — one forward over a padded
  prompt window that writes the prompt's K/V into the paged pools and
  returns only the last real position's logits ``[B, vocab]``;
- ``decode(tokens, positions, active, ctx, tables, k, v)`` — the
  fixed-shape ``[max_batch, 1]`` decode step: append one position per live
  lane, attend through the block tables, return ``[B, vocab]``;
- ``prefill_chunked(ids, start, seg_lens, tables, k, v)`` — a window at
  per-row starting positions whose tokens attend to the already-cached
  prefix through the block tables (kind "chunked"); returns the last real
  position's logits like ``prefill``.

Inputs are host numpy arrays, as in the reference; the pools are the
model's device tensors and are updated in place (the returned ``k, v`` are
the same lists). Every entry point runs under ``torch.inference_mode()``.
The lm head runs on the selected last positions only, so the full
``[B, S, vocab]`` logits never exist.

The speculative ``verify`` entry point waits for the spec-decoding port
(ROADMAP).
"""
from __future__ import annotations

import inspect
from typing import Optional

import numpy as np
import torch

from ...framework.device import resolve_device, same_device
from ...models.gpt import GPTKVCache

__all__ = ["CachedDecoder", "supports_cached_decode"]


def supports_cached_decode(model) -> bool:
    """True when ``model.forward`` accepts a ``cache`` argument and the
    model can build its own paged pools."""
    fwd = getattr(model, "forward", None)
    if fwd is None or not callable(getattr(model, "init_kv_pools", None)):
        return False
    try:
        return "cache" in inspect.signature(fwd).parameters
    except (TypeError, ValueError):
        return False


class CachedDecoder:
    """Prefill/decode dispatch for one model instance.

    ``page_size``/``pages_per_seq`` fix the block-table geometry;
    ``max_batch`` fixes the decode-step shape. ``device`` (default: the
    CUDA device; ``"cpu"`` must be asked for) must be the model's.
    ``use_kernels`` routes attention through the hand-written kernels
    (default) or through their plain versions.
    """

    def __init__(self, model, *, max_batch: int, page_size: int,
                 pages_per_seq: int, max_positions: Optional[int] = None,
                 use_kernels: bool = True, device=None):
        if not supports_cached_decode(model):
            raise TypeError(
                f"{type(model).__name__} does not support KV-cached decode "
                f"(forward must accept cache=, and the model must expose "
                f"init_kv_pools)")
        self.device = resolve_device(device)
        if not same_device(model.device, self.device):
            raise ValueError(f"the model is on {model.device}, the decoder "
                             f"on {self.device}")
        self.model = model
        self.max_batch = int(max_batch)
        self.page_size = int(page_size)
        self.pages_per_seq = int(pages_per_seq)
        self.use_kernels = bool(use_kernels)
        self.max_positions = int(
            max_positions if max_positions is not None
            else model.kv_cache_spec()["max_seq_len"])

    def _t(self, a, dtype) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(
            self.device)

    def _run(self, kind, ids, positions, valid, ctx, tables, k, v, last_idx):
        cache = GPTKVCache(kind, self.page_size, k, v, tables, ctx, valid,
                           positions, use_kernels=self.use_kernels)
        h, (k2, v2) = self.model.gpt(ids, cache=cache)
        rows = torch.arange(h.shape[0], device=h.device)
        return self.model.logits(h[rows, last_idx]), k2, v2

    @torch.inference_mode()
    def prefill(self, ids: np.ndarray, prompt_lens: np.ndarray,
                tables: np.ndarray, k, v):
        """ids [B, S] (left-aligned, zero-padded); prompt_lens [B] (0 = dead
        pad row); tables [B, P]. Returns ``(last_logits [B, vocab], k,
        v)``."""
        ids_t = self._t(ids, np.int64)
        lens = self._t(prompt_lens, np.int32)
        b, s = ids_t.shape
        positions = torch.arange(s, dtype=torch.int32,
                                 device=self.device).expand(b, s)
        valid = positions < lens[:, None]
        last = (lens.long() - 1).clamp(0, s - 1)
        return self._run("prefill", ids_t, positions, valid, lens,
                         self._t(tables, np.int32), k, v, last)

    @torch.inference_mode()
    def prefill_chunked(self, ids: np.ndarray, start: np.ndarray,
                        seg_lens: np.ndarray, tables: np.ndarray, k, v):
        """ids [B, S] (left-aligned window tokens); start [B] per-row
        absolute offset; seg_lens [B] real window lengths; tables [B, P].
        Returns ``(last_logits [B, vocab], k, v)``."""
        ids_t = self._t(ids, np.int64)
        start_t = self._t(start, np.int32)
        seg = self._t(seg_lens, np.int32)
        b, s = ids_t.shape
        offs = torch.arange(s, dtype=torch.int32, device=self.device)[None]
        positions = start_t[:, None] + offs
        # positions past the model's range write to the trash page and mask
        # themselves out
        valid = (offs < seg[:, None]) & (positions < self.max_positions)
        ctx = start_t + seg
        last = (seg.long() - 1).clamp(0, s - 1)
        return self._run("chunked", ids_t, positions, valid, ctx,
                         self._t(tables, np.int32), k, v, last)

    @torch.inference_mode()
    def decode(self, tokens: np.ndarray, positions: np.ndarray,
               active: np.ndarray, ctx: np.ndarray, tables: np.ndarray,
               k, v):
        """One fixed-shape decode step. tokens [B]; positions [B] (slot being
        written); active [B] bool; ctx [B] visible length INCLUDING this
        token; tables [B, P]. Returns ``(logits [B, vocab], k, v)``."""
        ids_t = self._t(tokens, np.int64)[:, None]
        zero = torch.zeros(ids_t.shape[0], dtype=torch.long,
                           device=self.device)
        return self._run("decode", ids_t, self._t(positions, np.int32)[:, None],
                         self._t(active, bool)[:, None],
                         self._t(ctx, np.int32), self._t(tables, np.int32),
                         k, v, zero)
