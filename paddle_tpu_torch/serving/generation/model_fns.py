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

Each entry point is one dispatch of an observability site
(``generate_prefill``, ``generate_decode``, ``generate_chunked``,
``generate_verify``), as the reference's (``model_fns.py:365-479``):

- xstats: the first dispatch of each signature registers and measures its
  entry (``observability/xstats.py``); later ones bump its counters. With
  ``FLAGS_compile_cache_dir`` set, the first dispatch of each (site,
  signature) in a decoder asks the compile cache, keyed on
  ``fingerprint()`` (the model's ``layer_fingerprint`` and the decode
  geometry), as the reference's ``_aot_exec`` (``:325-360``): a hit loads
  the stored record and skips the measurement;
- numerics tripwires (``FLAGS_check_nan_inf`` or
  ``FLAGS_numerics_sample_rate``): the logits' health stats, and over int8
  pools the scale planes' magnitude, are noted without a sync;
- shadow checks (``FLAGS_numerics_shadow_rate``, the decode, chunked and
  verify sites): BEFORE the real call, the same forward runs through the
  kernels' plain versions on a compact copy of only the pages the batch's
  block tables name (tables remapped onto the copy), so the live pools,
  tables and everything the engine holds come out bit for bit as without
  the shadow; the max-abs logit divergence is noted. Its plain calls count
  in the wrappers' ``plain_calls``.

``mesh=`` (a ``serving.mesh.ServingMesh``, a ``distributed.mesh_utils.Mesh``
or None) makes the decoder tensor-parallel, as the reference's
(``model_fns.py:73-238``): a live mesh places the weights by their spec tree
once (``ServingMesh.place_state``), every entry point takes pools placed by
``ServingMesh.place_pools`` (``MeshTensor`` leaves, heads-sharded) and runs
``models.gpt.mesh_forward``: per layer each slot runs its heads through the
same kernels, partial sums reduced in slot order. The mesh joins the
fingerprint and each compile-cache key. An inert mesh (None, one slot)
changes nothing.
"""
from __future__ import annotations

import inspect
from typing import Optional

import numpy as np
import torch

from ...framework.device import resolve_device, same_device
from ...models.gpt import (GPTKVCache, is_stacked_pool, layer_pool,
                           mesh_forward, mesh_logits, pools_of_slot)
from ...observability import numerics, xstats
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
                 device=None, donate: Optional[bool] = None, mesh=None):
        from ..mesh import ServingMesh
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
        # xstats memo: (site, shapes) -> ExecEntry
        self._xstats_entries = {}
        self._fp: Optional[str] = None
        # each site's last compile-cache result ("hit", "miss", or None
        # when the dispatch did not ask the cache)
        self.cache_outcomes = {}
        self._dtype_label = self.kv_dtype or (
            "f32" if self._pool_dtype == torch.float32
            else str(self._pool_dtype).replace("torch.", ""))
        smesh = mesh if isinstance(mesh, ServingMesh) else ServingMesh(mesh)
        smesh.validate_heads(int(spec["num_heads"]))
        self.serving_mesh = smesh
        # the weights placed once by their spec tree (live mesh only)
        self._placed = None
        if smesh.live:
            if not same_device(smesh.slots[0], self.device):
                raise ValueError(f"the serving mesh's first slot is "
                                 f"{smesh.slots[0]}, the decoder on "
                                 f"{self.device}")
            self._placed, _ = smesh.place_state(model=model)

    def refresh_weights(self) -> None:
        """Re-place the model's current weights on the live mesh (after a
        weight load; the placement is a copy). A no-op when inert."""
        if self.serving_mesh.live:
            self._placed, _ = self.serving_mesh.place_state(model=self.model)

    def fingerprint(self) -> str:
        """Stable identity of (the model's code, configuration and
        parameter layout, the decode geometry) for compile-cache keys and
        the warmup manifest (reference ``model_fns.py:293``)."""
        if self._fp is None:
            import hashlib
            import json

            from ...compile_cache import layer_fingerprint
            geom = {"max_batch": self.max_batch,
                    "page_size": self.page_size,
                    "pages_per_seq": self.pages_per_seq,
                    "max_positions": self.max_positions,
                    "use_kernels": self.use_kernels,
                    "kv_dtype": self.kv_dtype, "v": 1}
            # only a live mesh joins: an inert one keeps today's
            # fingerprint byte for byte
            mesh_parts = self.serving_mesh.fingerprint_parts(self.model)
            if mesh_parts is not None:
                geom["serving_mesh"] = mesh_parts
            h = hashlib.sha256(layer_fingerprint(self.model).encode())
            h.update(json.dumps(geom, sort_keys=True).encode())
            self._fp = h.hexdigest()
        return self._fp

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
        pool = layer_pool(self._slot0(k), 0)
        got = "int8" if is_quantized_pool(pool) else pool.dtype
        if got != self._pool_dtype:
            raise ValueError(f"the decoder was built for {self._pool_dtype} "
                             f"pools (kv_dtype={self.kv_dtype!r}), got "
                             f"{got} pools")

    def _slot0(self, pools):
        """Slot 0's view of placed pools (the pools themselves when the
        mesh is inert)."""
        return pools_of_slot(pools, 0) if self._placed is not None \
            else pools

    def _run(self, kind, ids, positions, valid, ctx, tables, k, v, last_idx,
             use_kernels=None):
        """One cached forward; the logits of each row's ``last_idx``
        position [B, vocab], or of every position [B, S, vocab] when
        ``last_idx`` is None."""
        cache = GPTKVCache(kind, self.page_size, k, v, tables, ctx, valid,
                           positions,
                           use_kernels=(self.use_kernels if use_kernels is None
                                        else use_kernels))
        if self._placed is not None:
            h = mesh_forward(self.model, self._placed, ids, cache)
            k2, v2 = k, v
        else:
            h, (k2, v2) = self.model.gpt(ids, cache=cache)
        if last_idx is not None:
            h = h[torch.arange(h.shape[0], device=h.device), last_idx]
        if self._placed is not None:
            return mesh_logits(self.model, self._placed, h), k2, v2
        return self.model.logits(h), k2, v2

    def _dispatch(self, site, kind, ids, positions, valid, ctx, tables_np,
                  k, v, last_idx):
        """One dispatch of ``site``: the shadow check first (sampled), then
        the real forward (measured by xstats at a signature's first
        dispatch), then the numerics notes."""
        self._check_pools(k)
        tables = self._t(tables_np, np.int32)
        args = (kind, ids, positions, valid, ctx)
        shadow = None
        if site in numerics.SHADOW_SITES and numerics.sample_decision(
                numerics.shadow_rate()):
            shadow = self._shadow(args, tables_np, k, v, last_idx)
        key = (site, tuple(ids.shape), tuple(tables.shape))
        out = xstats.observed_call(
            self._xstats_entries, key, site,
            lambda: self._run(*args, tables, k, v, last_idx),
            signature_fn=lambda: xstats.signature_of(
                [ids, positions, valid, ctx, tables,
                 layer_pool(self._slot0(k), 0)]),
            device=self.device, identity=self.fingerprint,
            outcome=self.cache_outcomes,
            mesh=self.serving_mesh.mesh_for_cache_key())
        try:
            kname = site[len("generate_"):]
            if shadow is not None:
                numerics.note_shadow_divergence(
                    kname, self._dtype_label,
                    (out[0].float() - shadow.float()).abs().max())
            if numerics.sample_decision(numerics.tripwire_rate()):
                numerics.note_serving_logits(kname, out[0])
                if self.kv_dtype == "int8":
                    numerics.note_int8_scales(kname, k, v)
        except Exception:  # noqa: BLE001 - never break a decode step
            pass
        return out

    def _shadow(self, args, tables_np, k, v, last_idx):
        """The forward through the kernels' plain versions on a compact
        copy of the pages ``tables_np`` names (page 0, the trash page,
        always among them), with the tables remapped onto the copy. Returns
        its logits, or None when it fails (a shadow never fails the
        dispatch)."""
        try:
            pages = np.union1d(np.asarray(tables_np, np.int64).reshape(-1),
                               [0])
            remap = np.searchsorted(pages, tables_np).astype(np.int32)
            idx = torch.from_numpy(pages).to(self.device)
            dim = 1 if self._stacked else 0

            def take(pool):
                if isinstance(pool, list):
                    return [take(p) for p in pool]
                if isinstance(pool, tuple):
                    return tuple(take(t) for t in pool)
                if hasattr(pool, "map"):    # a placed pool's shards
                    return pool.map(lambda t: t.index_select(
                        dim, idx.to(t.device)))
                return pool.index_select(dim, idx)

            return self._run(*args, self._t(remap, np.int32), take(k),
                             take(v), last_idx, use_kernels=False)[0]
        except Exception:  # noqa: BLE001 - observability is garnish
            return None

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
        return self._dispatch("generate_prefill", "prefill", ids_t,
                              positions, valid, lens, tables, k, v, last)

    def _chunked(self, site, ids, start, seg_lens, tables, k, v,
                 last: bool):
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
        return self._dispatch(site, "chunked", ids_t, positions, valid, ctx,
                              tables, k, v, last_idx)

    @torch.inference_mode()
    def prefill_chunked(self, ids: np.ndarray, start: np.ndarray,
                        seg_lens: np.ndarray, tables: np.ndarray, k, v):
        """Suffix prefill after a prefix-cache hit. ids [B, S] (left-aligned
        suffix tokens); start [B] per-row absolute offset (the matched
        prefix length; 0 = dead row); seg_lens [B] real suffix lengths;
        tables [B, P] (prefix pages first, then the row's own). Returns
        ``(last_logits [B, vocab], k, v)``."""
        self.calls["chunked"] += 1
        return self._chunked("generate_chunked", ids, start, seg_lens,
                             tables, k, v, last=True)

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
        return self._chunked("generate_verify", tokens, start, seg_lens,
                             tables, k, v, last=False)

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
        return self._dispatch("generate_decode", "decode", ids_t,
                              self._t(positions, np.int32)[:, None],
                              self._t(active, bool)[:, None],
                              self._t(ctx, np.int32), tables, k, v, zero)
