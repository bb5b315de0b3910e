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
  prefix through the block tables (kind "chunked"): the suffix prefill of a
  prefix-cache hit; returns the last real position's logits like
  ``prefill``;
- ``verify(tokens, start, seg_lens, tables, k, v)`` — the same chunked
  forward over the speculative ``[last_accepted, d_1..d_k]`` window,
  returning ALL window logits ``[B, k+1, vocab]``.

Inputs are host numpy arrays, as in the reference; the pools are the
model's device tensors (or int8 ``(values, scales)`` tuples): per-layer
lists, or one stacked pool per side for the stacked decoder. They are
updated in place (the returned ``k, v`` are the same objects). Every entry
point runs under ``torch.inference_mode()``. Except in ``verify``, the lm
head runs on the selected last positions only, so the full ``[B, S,
vocab]`` logits never exist. ``calls`` counts each entry point's calls.
"""
from __future__ import annotations

import inspect
from typing import Optional

import numpy as np
import torch

from ...framework.device import resolve_device, same_device
from ...models.gpt import GPTKVCache, is_stacked_pool, layer_pool
from ...ops.paged_attention import is_quantized_pool, resolve_kv_dtype

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
    (default) or through their plain versions. ``kv_dtype`` names the
    pools' storage type ('' = the model's, or a FLAGS_decode_kv_dtype
    value); the pools themselves come from the caller, and every entry
    point refuses pools of another type. ``donate`` is accepted for the
    reference's surface and has no effect: the pools are written in place,
    which is what the reference's buffer donation buys.
    """

    def __init__(self, model, *, max_batch: int, page_size: int,
                 pages_per_seq: int, max_positions: Optional[int] = None,
                 use_kernels: bool = True, kv_dtype: str = "",
                 device=None, donate: Optional[bool] = None):
        if not supports_cached_decode(model):
            raise TypeError(
                f"{type(model).__name__} does not support KV-cached decode "
                f"(forward must accept cache=, and the model must expose "
                f"init_kv_pools)")
        del donate      # in-place pool writes: nothing to donate
        self.device = resolve_device(device)
        if not same_device(model.device, self.device):
            raise ValueError(f"the model is on {model.device}, the decoder "
                             f"on {self.device}")
        self.model = model
        self.max_batch = int(max_batch)
        self.page_size = int(page_size)
        self.pages_per_seq = int(pages_per_seq)
        self.use_kernels = bool(use_kernels)
        self.kv_dtype = str(kv_dtype or "")
        self._pool_dtype = resolve_kv_dtype(self.kv_dtype) or model.dtype
        self.calls = {"prefill": 0, "chunked": 0, "verify": 0, "decode": 0}
        spec = model.kv_cache_spec()
        self._stacked = bool(spec["stacked"])
        self.max_positions = int(max_positions if max_positions is not None
                                 else spec["max_seq_len"])

    def _t(self, a, dtype) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(
            self.device)

    def _check_pools(self, k):
        """Raise unless the pools have the structure of the model's
        (per-layer lists for the module stack, one stacked pool for the
        stacked decoder) and the storage type ``kv_dtype`` names: int8
        (values, scales) tuples, or float pools of that dtype."""
        if is_stacked_pool(k) != self._stacked:
            want = ("one stacked pool" if self._stacked
                    else "a list of per-layer pools")
            raise ValueError(f"the model takes {want} per side, got a "
                             f"{type(k).__name__}")
        pool = layer_pool(k, 0)
        got = "int8" if is_quantized_pool(pool) else pool.dtype
        if got != self._pool_dtype:
            raise ValueError(f"the decoder was built for {self._pool_dtype} "
                             f"pools (kv_dtype={self.kv_dtype!r}), got "
                             f"{got} pools")

    def _run(self, kind, ids, positions, valid, ctx, tables, k, v, last_idx):
        """One cached forward; the logits of each row's ``last_idx``
        position [B, vocab], or of every position [B, S, vocab] when
        ``last_idx`` is None."""
        self._check_pools(k)
        cache = GPTKVCache(kind, self.page_size, k, v, tables, ctx, valid,
                           positions, use_kernels=self.use_kernels)
        h, (k2, v2) = self.model.gpt(ids, cache=cache)
        if last_idx is not None:
            h = h[torch.arange(h.shape[0], device=h.device), last_idx]
        return self.model.logits(h), k2, v2

    @torch.inference_mode()
    def prefill(self, ids: np.ndarray, prompt_lens: np.ndarray,
                tables: np.ndarray, k, v):
        """ids [B, S] (left-aligned, zero-padded); prompt_lens [B] (0 = dead
        pad row); tables [B, P]. Returns ``(last_logits [B, vocab], k,
        v)``."""
        self.calls["prefill"] += 1
        ids_t = self._t(ids, np.int64)
        lens = self._t(prompt_lens, np.int32)
        b, s = ids_t.shape
        positions = torch.arange(s, dtype=torch.int32,
                                 device=self.device).expand(b, s)
        valid = positions < lens[:, None]
        last = (lens.long() - 1).clamp(0, s - 1)
        return self._run("prefill", ids_t, positions, valid, lens,
                         self._t(tables, np.int32), k, v, last)

    def _chunked(self, ids, start, seg_lens, tables, k, v, last: bool):
        ids_t = self._t(ids, np.int64)
        start_t = self._t(start, np.int32)
        seg = self._t(seg_lens, np.int32)
        b, s = ids_t.shape
        offs = torch.arange(s, dtype=torch.int32, device=self.device)[None]
        positions = start_t[:, None] + offs
        # positions past the model's range (a verify window overhanging the
        # budget) write to the trash page and mask themselves out; their
        # logits are garbage the host never reads
        valid = (offs < seg[:, None]) & (positions < self.max_positions)
        ctx = start_t + seg
        last_idx = (seg.long() - 1).clamp(0, s - 1) if last else None
        return self._run("chunked", ids_t, positions, valid, ctx,
                         self._t(tables, np.int32), k, v, last_idx)

    @torch.inference_mode()
    def prefill_chunked(self, ids: np.ndarray, start: np.ndarray,
                        seg_lens: np.ndarray, tables: np.ndarray, k, v):
        """Suffix prefill after a prefix-cache hit. ids [B, S] (left-aligned
        suffix tokens); start [B] per-row absolute offset (the matched
        prefix length; 0 = dead row); seg_lens [B] real suffix lengths;
        tables [B, P] (prefix pages first, then the row's own). Returns
        ``(last_logits [B, vocab], k, v)``."""
        self.calls["chunked"] += 1
        return self._chunked(ids, start, seg_lens, tables, k, v, last=True)

    @torch.inference_mode()
    def verify(self, tokens: np.ndarray, start: np.ndarray,
               seg_lens: np.ndarray, tables: np.ndarray, k, v):
        """Speculative verify: one chunked forward over the
        ``[last_accepted, d_1..d_k]`` window per lane, returning ALL window
        logits ``[B, k+1, vocab]`` so the host judges every proposal from
        one step. Rejected positions' K/V writes land on the lane's own
        reserved pages and are rolled back by truncating the context
        length, never by touching the pool. Returns ``(logits, k, v)``."""
        self.calls["verify"] += 1
        return self._chunked(tokens, start, seg_lens, tables, k, v,
                             last=False)

    @torch.inference_mode()
    def decode(self, tokens: np.ndarray, positions: np.ndarray,
               active: np.ndarray, ctx: np.ndarray, tables: np.ndarray,
               k, v):
        """One fixed-shape decode step. tokens [B]; positions [B] (slot being
        written); active [B] bool; ctx [B] visible length INCLUDING this
        token; tables [B, P]. Returns ``(logits [B, vocab], k, v)``."""
        self.calls["decode"] += 1
        ids_t = self._t(tokens, np.int64)[:, None]
        zero = torch.zeros(ids_t.shape[0], dtype=torch.long,
                           device=self.device)
        return self._run("decode", ids_t, self._t(positions, np.int32)[:, None],
                         self._t(active, bool)[:, None],
                         self._t(ctx, np.int32), self._t(tables, np.int32),
                         k, v, zero)
