"""GPT decoder-only transformer (the port of ``paddle_tpu/models/gpt.py``).

Same configuration presets, same module tree and the same parameter names
as the reference, so ``state_dict()`` keys match the JAX package's
(``gpt.embeddings.word_embeddings.weight``,
``gpt.layers.{i}.attn.qkv_proj.weight``, ...) and ``convert.py`` moves
weights across by name. Pre-LN blocks, head-major fused qkv
(``[b, s, nh, 3, hd]``), tanh-approximate GELU, and an lm_head tied to the
word embeddings by default.

Attention goes through the port's kernels: the uncached forward and the
serving prefill through the flash-attention forward
(``ops/cuda_attention.py``), decode and chunked windows through the paged
kernel (``ops/cuda_paged_attention.py``), both reading the strided q/k/v
views of the fused projection without a copy.

Precision: everything runs in the model's dtype, as the reference: the
residual stream, the layer norms (which normalise in float32 and round their
output back) and the logits.

Training goes through ``jit/train_step.py``: the uncached forward's
attention is differentiable (``ops/flash_attention.FlashAttention``, whose
backward is the two backward kernels), ``GPTPretrainingCriterion`` is the
loss, and the port's AMP (``amp/auto_cast.py``) casts the float32 master
weights op by op as the reference does. ``dropout > 0`` in training raises
``NotImplementedError`` (ROADMAP).

Only the per-layer module stack is ported; ``stacked=True`` (the
layer-stacked scan decoder) raises ``NotImplementedError`` (ROADMAP).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from ..framework.device import resolve_device
from ..nn.functional.loss import cross_entropy
from ..ops.flash_attention import attention_bshd
from ..ops.paged_attention import (flat_slots, kv_pool_bytes,
                                  paged_attention_update)

__all__ = ["GPTConfig", "GPTKVCache", "GPTEmbeddings", "GPTAttention",
           "GPTMLP", "GPTDecoderLayer", "GPTModel", "GPTForCausalLM",
           "GPTPretrainingCriterion", "gpt_tiny", "gpt2_small", "gpt2_medium",
           "gpt2_large", "gpt3_1p3b"]


@dataclass
class GPTConfig:
    vocab_size: int = 50304
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    max_seq_len: int = 1024
    intermediate_size: int = 0       # 0 → 4*hidden
    dropout: float = 0.0
    layer_norm_eps: float = 1e-5
    initializer_range: float = 0.02
    tie_word_embeddings: bool = True
    stacked: bool = False

    def __post_init__(self):
        if self.intermediate_size == 0:
            self.intermediate_size = 4 * self.hidden_size
        if self.hidden_size % self.num_heads:
            raise ValueError(f"hidden_size {self.hidden_size} is not a "
                             f"multiple of num_heads {self.num_heads}")


def gpt_tiny(**kw) -> GPTConfig:
    d = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
             max_seq_len=128)
    d.update(kw)
    return GPTConfig(**d)


def gpt2_small(**kw) -> GPTConfig:
    d = dict(vocab_size=50304, hidden_size=768, num_layers=12, num_heads=12,
             max_seq_len=1024)
    d.update(kw)
    return GPTConfig(**d)


def gpt2_medium(**kw) -> GPTConfig:
    d = dict(vocab_size=50304, hidden_size=1024, num_layers=24,
             num_heads=16, max_seq_len=1024)
    d.update(kw)
    return GPTConfig(**d)


def gpt2_large(**kw) -> GPTConfig:
    d = dict(vocab_size=50304, hidden_size=1280, num_layers=36,
             num_heads=20, max_seq_len=1024)
    d.update(kw)
    return GPTConfig(**d)


def gpt3_1p3b(**kw) -> GPTConfig:
    d = dict(vocab_size=50304, hidden_size=2048, num_layers=24, num_heads=16,
             max_seq_len=2048)
    d.update(kw)
    return GPTConfig(**d)


class GPTKVCache:
    """Paged KV-cache view threaded through ``GPTModel.forward``.

    - ``k``/``v``: per-layer pools, lists of ``[num_pages, page_size,
      heads, head_dim]`` tensors (page 0 is the trash page); updated in
      place by the forward.
    - ``block_tables``: [B, P] int32 logical-page → pool-page map.
    - ``ctx_len``: [B] visible context INCLUDING the positions written by
      this forward.
    - ``valid``: [B, S] bool, which fed positions are real (their K/V
      writes go to the trash page otherwise).
    - ``positions``: [B, S] absolute positions being fed.
    - ``kind``: "prefill", "decode" (S = 1) or "chunked" (a window at
      non-zero starting positions).
    - ``use_kernels``: the hand-written kernels (default) or their plain
      versions (ops/paged_attention.paged_attention_update).

    The flat pool slots of the fed positions are the same for every layer,
    so they are computed once here and shared by the per-layer views.
    """

    __slots__ = ("kind", "page_size", "k", "v", "block_tables", "ctx_len",
                 "valid", "positions", "use_kernels", "slots")

    def __init__(self, kind, page_size, k, v, block_tables, ctx_len, valid,
                 positions, use_kernels: bool = True, slots=None):
        if kind not in ("prefill", "decode", "chunked"):
            raise ValueError(f"kind must be 'prefill', 'decode' or "
                             f"'chunked', got {kind!r}")
        self.kind = kind
        self.page_size = int(page_size)
        self.k = k
        self.v = v
        self.block_tables = block_tables
        self.ctx_len = ctx_len
        self.valid = valid
        self.positions = positions
        self.use_kernels = bool(use_kernels)
        self.slots = slots if slots is not None else flat_slots(
            block_tables, positions, valid, self.page_size).reshape(-1)

    def layer(self, i: int) -> "GPTKVCache":
        """The view one decoder layer sees: its own pools."""
        return GPTKVCache(self.kind, self.page_size, self.k[i], self.v[i],
                          self.block_tables, self.ctx_len, self.valid,
                          self.positions, self.use_kernels, self.slots)


class GPTEmbeddings(nn.Module):
    def __init__(self, config: GPTConfig, device=None, dtype=None):
        super().__init__()
        self.max_seq_len = config.max_seq_len
        self.word_embeddings = nn.Embedding(
            config.vocab_size, config.hidden_size, device=device,
            dtype=dtype)
        self.position_embeddings = nn.Parameter(torch.empty(
            config.max_seq_len, config.hidden_size, device=device,
            dtype=dtype))
        self.dropout = nn.Dropout(config.dropout)

    def forward(self, input_ids, positions=None):
        h = self.word_embeddings(input_ids)
        if positions is not None:
            # cached path: each row sits at its own absolute positions
            # (positions past the table only occur on masked lanes)
            pos = positions.long().clamp(0, self.max_seq_len - 1)
            h = h + F.embedding(pos, self.position_embeddings)
        else:
            h = h + self.position_embeddings[:input_ids.shape[-1]]
        return self.dropout(h)


class GPTAttention(nn.Module):
    """Fused-qkv attention. ``use_kernels`` (an attribute, True by default)
    picks the hand-written kernels or their plain versions for the uncached
    forward and its gradient, as ``GPTKVCache.use_kernels`` does for the
    cached paths."""

    def __init__(self, config: GPTConfig, device=None, dtype=None):
        super().__init__()
        self.use_kernels = True
        self.num_heads = config.num_heads
        self.head_dim = config.hidden_size // config.num_heads
        self.hidden_size = config.hidden_size
        self.qkv_proj = nn.Linear(config.hidden_size, 3 * config.hidden_size,
                                  device=device, dtype=dtype)
        self.out_proj = nn.Linear(config.hidden_size, config.hidden_size,
                                  device=device, dtype=dtype)
        self.dropout = nn.Dropout(config.dropout)

    def forward(self, x, kv_cache: Optional[GPTKVCache] = None):
        b, s, _ = x.shape
        # head-major (nh, 3, hd) layout, as the reference: q/k/v are
        # strided views that the kernels read without a copy
        qkv = self.qkv_proj(x).view(b, s, self.num_heads, 3, self.head_dim)
        q, k, v = qkv.unbind(3)    # one stacked gradient, not three
        if kv_cache is not None:
            out, k_pool, v_pool = paged_attention_update(
                q, k, v, kv_cache.k, kv_cache.v, kv_cache.block_tables,
                kv_cache.ctx_len, kv_cache.valid, kv_cache.positions,
                page_size=kv_cache.page_size, kind=kv_cache.kind,
                use_kernels=kv_cache.use_kernels, slots=kv_cache.slots)
            out = out.reshape(b, s, self.hidden_size)
            return self.dropout(self.out_proj(out)), k_pool, v_pool
        out = attention_bshd(q, k, v, causal=True,
                             scale=1.0 / math.sqrt(self.head_dim),
                             use_kernels=self.use_kernels)
        return self.dropout(self.out_proj(out.reshape(b, s,
                                                      self.hidden_size)))


class GPTMLP(nn.Module):
    def __init__(self, config: GPTConfig, device=None, dtype=None):
        super().__init__()
        self.fc_in = nn.Linear(config.hidden_size, config.intermediate_size,
                               device=device, dtype=dtype)
        self.fc_out = nn.Linear(config.intermediate_size, config.hidden_size,
                                device=device, dtype=dtype)
        self.dropout = nn.Dropout(config.dropout)

    def forward(self, x):
        # tanh-approximate gelu (GPT-2's "gelu_new"), as the reference
        return self.dropout(self.fc_out(F.gelu(self.fc_in(x),
                                               approximate="tanh")))


class GPTDecoderLayer(nn.Module):
    """Pre-LN decoder block: ``x + attn(ln_1(x))``, then ``x +
    mlp(ln_2(x))``."""

    def __init__(self, config: GPTConfig, device=None, dtype=None):
        super().__init__()
        eps = config.layer_norm_eps
        self.ln_1 = nn.LayerNorm(config.hidden_size, eps=eps, device=device,
                                 dtype=dtype)
        self.attn = GPTAttention(config, device, dtype)
        self.ln_2 = nn.LayerNorm(config.hidden_size, eps=eps, device=device,
                                 dtype=dtype)
        self.mlp = GPTMLP(config, device, dtype)

    def forward(self, x, kv_cache: Optional[GPTKVCache] = None):
        if kv_cache is not None:
            a, k_pool, v_pool = self.attn(self.ln_1(x), kv_cache=kv_cache)
            x = x + a
            x = x + self.mlp(self.ln_2(x))
            return x, k_pool, v_pool
        x = x + self.attn(self.ln_1(x))
        return x + self.mlp(self.ln_2(x))


class GPTModel(nn.Module):
    def __init__(self, config: GPTConfig, device=None, dtype=None):
        super().__init__()
        if config.stacked:
            raise NotImplementedError(
                "the layer-stacked decoder (stacked=True) is not ported yet "
                "(ROADMAP queue 1: the stacked decoder)")
        self.config = config
        self.embeddings = GPTEmbeddings(config, device, dtype)
        self.layers = nn.ModuleList([GPTDecoderLayer(config, device, dtype)
                                     for _ in range(config.num_layers)])
        self.ln_f = nn.LayerNorm(config.hidden_size,
                                 eps=config.layer_norm_eps, device=device,
                                 dtype=dtype)

    def forward(self, input_ids, cache: Optional[GPTKVCache] = None):
        """Uncached: the final hidden states [B, S, hidden].
        Cached: ``(h, (k_pools, v_pools))`` — the pools are the cache's own
        tensors, updated in place."""
        if cache is None:
            if self.training and self.config.dropout > 0 and \
                    torch.is_grad_enabled():
                raise NotImplementedError(
                    "dropout > 0 in training is not ported yet (ROADMAP "
                    "queue 1 item 7: dropout with the port's own random "
                    "stream, attention probabilities included)")
            h = self.embeddings(input_ids)
            for layer in self.layers:
                h = layer(h)
            return self.ln_f(h)
        h = self.embeddings(input_ids, positions=cache.positions)
        k_new, v_new = [], []
        for i, layer in enumerate(self.layers):
            h, k_i, v_i = layer(h, kv_cache=cache.layer(i))
            k_new.append(k_i)
            v_new.append(v_i)
        return self.ln_f(h), (k_new, v_new)


class GPTForCausalLM(nn.Module):
    """GPT with a causal-LM head. Built on ``device`` (default: the CUDA
    device; ``device="cpu"`` must be asked for) in ``dtype``, with every
    weight drawn from a ``torch.Generator`` seeded with ``seed``:
    projections and embeddings N(0, initializer_range), biases 0, layer
    norms 1/0."""

    def __init__(self, config: GPTConfig, *, device=None,
                 dtype: torch.dtype = torch.float32, seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        self.gpt = GPTModel(config, device, dtype)
        if not config.tie_word_embeddings:
            self.lm_head = nn.Linear(config.hidden_size, config.vocab_size,
                                     bias=False, device=device, dtype=dtype)
        self.reset_parameters(seed)

    @property
    def device(self) -> torch.device:
        return self.gpt.embeddings.word_embeddings.weight.device

    @property
    def dtype(self) -> torch.dtype:
        """The model's dtype: weights, activations and the KV pools."""
        return self.gpt.embeddings.word_embeddings.weight.dtype

    @torch.no_grad()
    def reset_parameters(self, seed: int = 0) -> None:
        g = torch.Generator(device=self.device).manual_seed(int(seed))
        std = self.config.initializer_range
        for module in self.modules():
            if isinstance(module, nn.Linear):
                module.weight.normal_(0.0, std, generator=g)
                if module.bias is not None:
                    module.bias.zero_()
            elif isinstance(module, nn.LayerNorm):
                module.weight.fill_(1.0)
                module.bias.zero_()
            elif isinstance(module, nn.Embedding):
                module.weight.normal_(0.0, std, generator=g)
        self.gpt.embeddings.position_embeddings.normal_(0.0, std,
                                                        generator=g)

    def logits(self, h):
        """The lm head over hidden states ``h [..., hidden]``: ``h @
        wte.T`` when tied, as the reference, in the model's dtype."""
        w = (self.gpt.embeddings.word_embeddings.weight
             if self.config.tie_word_embeddings else self.lm_head.weight)
        return F.linear(h, w)

    def forward(self, input_ids, cache: Optional[GPTKVCache] = None):
        if cache is not None:
            h, pools = self.gpt(input_ids, cache=cache)
            return self.logits(h), pools
        return self.logits(self.gpt(input_ids))

    # ---- paged KV-cache plumbing (serving.generation engine) ----
    def init_kv_pools(self, num_pages: int, page_size: int, dtype=None):
        """Zeroed per-layer K/V pools ``[num_pages, page_size, heads,
        head_dim]`` on the model's device, in ``dtype`` (default: the
        model's). Page 0 is the trash page and is never allocated."""
        if isinstance(dtype, str):
            if dtype == "int8":
                raise NotImplementedError(
                    "int8 KV pools are not ported yet (ROADMAP queue 2: the "
                    "int8 variant of the paged-attention kernel)")
            dtype = getattr(torch, dtype)
        cfg = self.config
        shape = (int(num_pages), int(page_size), cfg.num_heads,
                 cfg.hidden_size // cfg.num_heads)
        dt = dtype or self.dtype
        mk = [torch.zeros(shape, dtype=dt, device=self.device)
              for _ in range(2 * cfg.num_layers)]
        return mk[:cfg.num_layers], mk[cfg.num_layers:]

    def kv_cache_spec(self, kv_dtype: str = "") -> dict:
        """Geometry the decode engine sizes its cache from."""
        cfg = self.config
        nh, hd = cfg.num_heads, cfg.hidden_size // cfg.num_heads
        per_token = cfg.num_layers * 2 * kv_pool_bytes(
            1, 1, nh, hd, kv_dtype or None)
        return {"num_layers": cfg.num_layers, "num_heads": nh,
                "head_dim": hd, "max_seq_len": cfg.max_seq_len,
                "stacked": False, "kv_dtype": kv_dtype or "",
                "kv_bytes_per_token": int(per_token)}

    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())


class GPTPretrainingCriterion(nn.Module):
    """Causal-LM loss (reference ``gpt.py:762-777``): logits ``[B, S, V]``
    against labels ``[B, S]`` shifted by one (position i predicts label
    i + 1), cross entropy with ``ignore_index``, the mean taken over the
    labels that are not ignored."""

    def __init__(self, ignore_index: int = -100):
        super().__init__()
        self.ignore_index = ignore_index

    def forward(self, logits, labels):
        lg = logits[:, :-1, :]
        lb = labels[:, 1:]
        b, s, v = lg.shape
        return cross_entropy(lg.reshape(b * s, v), lb.reshape(b * s),
                             ignore_index=self.ignore_index)
