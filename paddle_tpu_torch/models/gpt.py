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
weights op by op as the reference does.

Dropout (``GPTConfig.dropout``) is applied where the reference applies it
(``paddle_tpu/models/gpt.py:205-306``): after the embeddings, on the
attention's output projection and on the MLP's output (``nn.Dropout``'s
port, drawing from the port's generator, ``framework/random.py``), and on
the attention probabilities, which in training takes the attention to the
reference's dense path (``nn/functional/attention.py``) instead of the
flash kernels, as the reference routes. The stacked decoder applies no
layer dropout, as the reference's (``gpt.py:61-65``); its embeddings do.

``stacked=True`` swaps the module stack for :class:`GPTStackedTransformer`
(reference ``gpt.py:333-636``): twelve layer-stacked parameters
(``gpt.decoder.qkv_w [L, H, 3H]``, ...; weights ``[in, out]``) run by
:func:`_stacked_layer_fwd`, a Python loop over the layers standing in for
the reference's ``lax.scan``, each layer wrapped by
``GPTConfig.recompute`` ("none", "full", "dots" or "attn"; see
``gpt_stacked_decoder``). Its KV cache is one ``[L, pages, page, H, D]``
pool (or an int8 pair of such pools) whose layer ``i`` is the contiguous
view ``pool[i]``.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F
from torch.overrides import handle_torch_function, has_torch_function
from torch.utils.checkpoint import checkpoint

from ..amp.auto_cast import auto_cast
from ..framework.device import resolve_device
from ..nn.functional.attention import scaled_dot_product_attention
from ..nn.functional.loss import cross_entropy
from ..nn.layer.common import Dropout
from ..ops.cuda_attention import (flash_attention_fwd, mha_fwd_reference,
                                  supported)
from ..ops.cuda_attention_bwd import flash_attention_bwd, mha_bwd_reference
from ..ops.flash_attention import attention_bshd
from ..ops.paged_attention import (flat_slots, kv_pool_bytes,
                                  paged_attention_update)

__all__ = ["GPTConfig", "GPTKVCache", "GPTEmbeddings", "GPTAttention",
           "GPTMLP", "GPTDecoderLayer", "GPTStackedTransformer",
           "gpt_stacked_decoder", "GPTModel", "GPTForCausalLM",
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
    # stacked=True: one decoder over layer-stacked parameters
    # (GPTStackedTransformer) instead of the per-layer module stack
    stacked: bool = False
    # activation recompute inside the stacked decoder (ignored otherwise):
    #   "full" — recompute every layer in the backward (least memory)
    #   "dots" — save the matmul outputs, recompute the elementwise work
    #   "attn" — save only the attention output (and its lse), so the
    #            backward never runs the flash forward again
    #   "none" — save everything (most memory, fewest operations)
    recompute: str = "full"

    def __post_init__(self):
        if self.intermediate_size == 0:
            self.intermediate_size = 4 * self.hidden_size
        if self.hidden_size % self.num_heads:
            raise ValueError(f"hidden_size {self.hidden_size} is not a "
                             f"multiple of num_heads {self.num_heads}")
        if self.recompute not in ("full", "dots", "attn", "none"):
            raise ValueError(
                f"recompute must be 'full', 'dots', 'attn' or 'none', "
                f"got {self.recompute!r}")


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
      heads, head_dim]`` tensors, or of int8 ``(values, scales)`` tuples,
      for the module stack; ONE stacked ``[num_layers, num_pages, ...]``
      tensor, or one int8 ``(values, scales)`` tuple of stacked tensors, for
      ``GPTStackedTransformer`` (page 0 is the trash page); updated in
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
        """The view one decoder layer sees: its own pools — entry ``i`` of
        a per-layer list, or slice ``i`` of every leaf of a stacked pool
        (a contiguous view, written in place)."""
        return GPTKVCache(self.kind, self.page_size, layer_pool(self.k, i),
                          layer_pool(self.v, i), self.block_tables,
                          self.ctx_len, self.valid, self.positions,
                          self.use_kernels, self.slots)


def is_stacked_pool(pools) -> bool:
    """True for a stacked decoder's pools (one tensor, or one int8 tuple of
    stacked tensors); False for a module stack's per-layer list."""
    return not isinstance(pools, list)


def layer_pool(pools, i: int):
    """Layer ``i``'s pool: ``pools[i]`` of a per-layer list, or the slice
    ``i`` of each leaf of a stacked pool (never ``values`` alone: indexing
    an int8 tuple would hand back its values tensor)."""
    if isinstance(pools, tuple):
        return tuple(leaf[i] for leaf in pools)
    return pools[i]


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
        self.dropout = Dropout(config.dropout)

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
    cached paths. With ``dropout > 0`` in training the uncached attention
    takes the reference's dense path (probability dropout); in eval, and in
    every cached path, dropout is off."""

    def __init__(self, config: GPTConfig, device=None, dtype=None):
        super().__init__()
        self.use_kernels = True
        self.num_heads = config.num_heads
        self.head_dim = config.hidden_size // config.num_heads
        self.hidden_size = config.hidden_size
        self.attn_dropout_p = config.dropout
        self.qkv_proj = nn.Linear(config.hidden_size, 3 * config.hidden_size,
                                  device=device, dtype=dtype)
        self.out_proj = nn.Linear(config.hidden_size, config.hidden_size,
                                  device=device, dtype=dtype)
        self.dropout = Dropout(config.dropout)

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
        out = scaled_dot_product_attention(
            q, k, v, is_causal=True, dropout_p=self.attn_dropout_p,
            training=self.training, scale=1.0 / math.sqrt(self.head_dim),
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
        self.dropout = Dropout(config.dropout)

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


# the stacked decoder's parameters, in the reference's order (SPECS,
# paddle_tpu/models/gpt.py:427-434)
STACKED_PARAMS = ("ln1_w", "ln1_b", "qkv_w", "qkv_b", "out_w", "out_b",
                  "ln2_w", "ln2_b", "fc1_w", "fc1_b", "fc2_w", "fc2_b")


def _ln32(h, w, b, eps):
    """The stacked decoder's layer norm: normalise in float32, cast back to
    ``h``'s type (reference ``gpt.py:350-355``)."""
    return F.layer_norm(h.float(), (h.shape[-1],), w.float(), b.float(),
                        eps).to(h.dtype)


def _qkv(x, ln1_w, ln1_b, qkv_w, qkv_b, *, num_heads, eps,
         matmul=torch.matmul):
    """A stacked layer up to its attention: ``ln1``, then the head-major
    qkv projection ``[mb, s, nh, 3, hd]``."""
    mb, s, hidden = x.shape
    qkv = matmul(_ln32(x, ln1_w, ln1_b, eps), qkv_w) + qkv_b
    return qkv.view(mb, s, num_heads, 3, hidden // num_heads)


def _after_attention(x, attn, out_w, out_b, ln2_w, ln2_b, fc1_w, fc1_b,
                     fc2_w, fc2_b, *, eps, matmul=torch.matmul):
    """A stacked layer from its attention output ``attn`` [mb, s, nh, hd]
    on: the out projection and the MLP, with the residuals added as ``x +
    o + out_b`` and ``x + d + fc2_b``."""
    x = x + matmul(attn.reshape(x.shape), out_w) + out_b
    h2 = _ln32(x, ln2_w, ln2_b, eps)
    u = F.gelu(matmul(h2, fc1_w) + fc1_b, approximate="tanh")
    return x + matmul(u, fc2_w) + fc2_b


def _stacked_layer_fwd(p, x, *, num_heads, eps, use_kernels=True,
                       kv: Optional[GPTKVCache] = None,
                       matmul=torch.matmul):
    """ONE decoder layer of the stacked decoder (reference
    ``_stacked_layer_fwd``, ``gpt.py:333-418``, at mp = sep = 1) on its
    parameter slices ``p`` (name → tensor, weights ``[in, out]``).

    Not ``GPTDecoderLayer`` with stacked weights, and bf16 tells them
    apart: the layer norms normalise in float32 and round to ``x``'s type,
    the projections are ``h @ w + b``, the residuals add as ``x + o +
    out_b`` and ``x + d + fc2_b``, and qkv is head-major ``[mb, s, nh, 3,
    hd]``. Uncached attention goes through ``attention_bshd``; with ``kv``
    (this layer's cache view) through ``paged_attention_update``, which
    writes the pools in place. ``matmul`` computes the four projections
    (the "dots" policy hands back products kept from the forward). Returns
    ``out`` [mb, s, H]."""
    qkv = _qkv(x, *(p[n] for n in STACKED_PARAMS[:4]), num_heads=num_heads,
               eps=eps, matmul=matmul)
    q, k, v = qkv.unbind(3)
    if kv is not None:
        attn, _, _ = paged_attention_update(
            q, k, v, kv.k, kv.v, kv.block_tables, kv.ctx_len, kv.valid,
            kv.positions, page_size=kv.page_size, kind=kv.kind,
            use_kernels=kv.use_kernels, slots=kv.slots)
    else:
        attn = attention_bshd(q, k, v, causal=True,
                              scale=1.0 / math.sqrt(q.shape[-1]),
                              use_kernels=use_kernels)
    return _after_attention(x, attn, *(p[n] for n in STACKED_PARAMS[4:]),
                            eps=eps, matmul=matmul)


class _AttentionRemat(torch.autograd.Function):
    """The "attn" policy's first segment of a layer: ``ln1``, the qkv
    projection and the flash forward. It saves the layer input and the
    attention's ``(out, lse)`` only; its backward recomputes ``ln1`` and
    qkv (not the attention) and runs the flash backward on the saved
    ``out`` and ``lse`` (the reference saves ``attn_out`` by name,
    ``gpt.py:408-412``, so that its backward never re-runs the flash
    forward)."""

    @staticmethod
    def forward(ctx, x, ln1_w, ln1_b, qkv_w, qkv_b, num_heads, eps,
                use_kernels):
        with auto_cast(enable=False):
            q, k, v = _qkv(x, ln1_w, ln1_b, qkv_w, qkv_b,
                           num_heads=num_heads, eps=eps).unbind(3)
        scale = 1.0 / math.sqrt(q.shape[-1])
        use_kernels = use_kernels and supported(q, k, v, True,
                                                backward=True)
        fwd = flash_attention_fwd if use_kernels else mha_fwd_reference
        out, lse = fwd(q, k, v, causal=True, scale=scale)
        ctx.save_for_backward(x, ln1_w, ln1_b, qkv_w, qkv_b, out, lse)
        ctx.num_heads, ctx.eps, ctx.scale = num_heads, eps, scale
        ctx.use_kernels = use_kernels
        return out

    @staticmethod
    def backward(ctx, dout):
        *inputs, out, lse = ctx.saved_tensors
        inputs = [t.detach().requires_grad_(t.requires_grad)
                  for t in inputs]
        with torch.enable_grad(), auto_cast(enable=False):
            qkv = _qkv(*inputs, num_heads=ctx.num_heads, eps=ctx.eps)
        q, k, v = qkv.detach().unbind(3)
        bwd = flash_attention_bwd if ctx.use_kernels else mha_bwd_reference
        grads = bwd(q, k, v, out, lse, dout.contiguous(), causal=True,
                    scale=ctx.scale)
        wanted = [t for t in inputs if t.requires_grad]
        got = iter(torch.autograd.grad(qkv, wanted,
                                       torch.stack(grads, dim=3)))
        return (*(next(got) if t.requires_grad else None for t in inputs),
                None, None, None)


class _KeptMatmul(torch.autograd.Function):
    """``h @ w`` whose value ``out`` was computed in the forward and kept:
    returns it, and backpropagates as the matmul does (``dh = g wᵀ``,
    ``dw = hᵀ g`` over the flattened rows)."""

    @staticmethod
    def forward(ctx, h, w, out):
        ctx.save_for_backward(h, w)
        return out.view_as(out)

    @staticmethod
    def backward(ctx, g):
        h, w = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1])
        dh = (g2 @ w.t()).view(h.shape) if ctx.needs_input_grad[0] else None
        dw = (h.reshape(-1, h.shape[-1]).t() @ g2
              if ctx.needs_input_grad[1] else None)
        return dh, dw, None


class _DotsKept:
    """The "dots" policy's matmul for one layer (the reference's
    ``dots_with_no_batch_dims_saveable``: the projections, not the
    attention's batched products): in the checkpointed forward, which runs
    without grad, it computes each projection and keeps it; in the
    recompute, which runs with grad in the backward, it hands them back in
    order through ``_KeptMatmul``, so only the elementwise work and the
    attention run again."""

    def __init__(self):
        self.kept = []

    def __call__(self, h, w):
        if torch.is_grad_enabled():
            return _KeptMatmul.apply(h, w, self.kept.pop(0))
        out = torch.matmul(h, w)
        self.kept.append(out)
        return out


def gpt_stacked_decoder(x, *params, config: GPTConfig,
                        use_kernels: bool = True):
    """The stacked decoder over ``x`` [B, S, H] with the twelve stacked
    parameters in ``STACKED_PARAMS`` order; returns [B, S, H].

    The reference runs it as ONE op, ``gpt_stacked_decoder``, and casts at
    that boundary only (``core/dispatch.py:63-67``): the call dispatches
    through ``__torch_function__``, so the port's AMP casts ``x`` and the
    parameters by that name (O2: all to the amp dtype; O1: nothing, since
    the op is on neither list, so the decoder runs in float32), and the
    body runs with AMP suspended.

    Each stacked parameter is split ONCE with ``unbind(0)`` (its backward
    is one ``stack``; indexing ``w[i]`` per layer would make autograd add
    a whole ``[L, ...]`` zero tensor per layer), and each layer runs under
    ``config.recompute`` (reference ``gpt.py:519-541``):

    - "none" keeps every activation;
    - "full" keeps the layer's input (``torch.utils.checkpoint``): the
      whole layer, the flash forward included, runs again in the backward;
    - "dots" keeps the input and the projections' outputs (``_DotsKept``);
      the layer norms, GELU, adds and the attention are recomputed;
    - "attn" keeps the input and the attention's output and lse
      (``_AttentionRemat``, then a checkpoint of the rest of the layer);
      the projections are recomputed, the attention is not.

    "full" and "attn" checkpoint without reentry, so the recompute stops
    once it has what the backward needs (the last projection's output is
    not); "dots" reenters, since its matmul tells the forward from the
    recompute by the grad mode. The layers draw no random numbers (the
    reference's stacked decoder applies no layer dropout), so the
    checkpoints do not save the generators' states."""
    if has_torch_function((x, *params)):
        return handle_torch_function(gpt_stacked_decoder, (x, *params), x,
                                     *params, config=config,
                                     use_kernels=use_kernels)
    nh, eps = config.num_heads, config.layer_norm_eps

    def layer(x, *slices, matmul=torch.matmul):
        with auto_cast(enable=False):
            return _stacked_layer_fwd(dict(zip(STACKED_PARAMS, slices)), x,
                                      num_heads=nh, eps=eps,
                                      use_kernels=use_kernels, matmul=matmul)

    def rest(x, attn, *slices):
        with auto_cast(enable=False):
            return _after_attention(x, attn, *slices, eps=eps)

    policy = config.recompute if torch.is_grad_enabled() else "none"
    for slices in zip(*(w.unbind(0) for w in params)):
        if policy == "none":
            x = layer(x, *slices)
        elif policy == "full":
            x = checkpoint(layer, x, *slices, use_reentrant=False,
                           preserve_rng_state=False)
        elif policy == "dots":
            x = checkpoint(functools.partial(layer, matmul=_DotsKept()), x,
                           *slices, use_reentrant=True,
                           preserve_rng_state=False)
        else:
            attn = _AttentionRemat.apply(x, *slices[:4], nh, eps,
                                         use_kernels)
            x = checkpoint(rest, x, attn, *slices[4:], use_reentrant=False,
                           preserve_rng_state=False)
    return x


class GPTStackedTransformer(nn.Module):
    """The decoder stack with layer-stacked parameters (reference
    ``GPTStackedTransformer``, ``gpt.py:421-636``) on one device: names
    and shapes as the reference's (``ln1_w [L, H]``, ``qkv_w [L, H, 3H]``,
    ..., ``fc2_b [L, H]``), weights ``[in, out]``. ``use_kernels`` (True by
    default) picks the hand-written kernels or their plain versions for the
    uncached forward, as ``GPTAttention.use_kernels`` does."""

    def __init__(self, config: GPTConfig, device=None, dtype=None):
        super().__init__()
        self.config = config
        self.use_kernels = True
        L, H, inter = (config.num_layers, config.hidden_size,
                       config.intermediate_size)
        shapes = {"ln1_w": (L, H), "ln1_b": (L, H), "qkv_w": (L, H, 3 * H),
                  "qkv_b": (L, 3 * H), "out_w": (L, H, H), "out_b": (L, H),
                  "ln2_w": (L, H), "ln2_b": (L, H), "fc1_w": (L, H, inter),
                  "fc1_b": (L, inter), "fc2_w": (L, inter, H),
                  "fc2_b": (L, H)}
        for name in STACKED_PARAMS:
            setattr(self, name, nn.Parameter(torch.empty(
                shapes[name], device=device, dtype=dtype)))

    @torch.no_grad()
    def reset_parameters(self, generator, std: float) -> None:
        """Weights N(0, std) from ``generator``, layer-norm scales 1,
        biases 0 (reference ``gpt.py:449-463``)."""
        for name in STACKED_PARAMS:
            p = getattr(self, name)
            if name.endswith("_b"):
                p.zero_()
            elif name.startswith("ln"):
                p.fill_(1.0)
            else:
                p.normal_(0.0, std, generator=generator)

    def forward(self, x, cache: Optional[GPTKVCache] = None):
        """Uncached: the decoder's output [B, S, H]. Cached: the same, with
        layer ``i`` reading and writing ``cache.layer(i)``'s pool views in
        place (reference ``_forward_cached``, ``gpt.py:567-634``)."""
        if cache is None:
            return gpt_stacked_decoder(
                x, *(getattr(self, n) for n in STACKED_PARAMS),
                config=self.config, use_kernels=self.use_kernels)
        cfg = self.config
        for i in range(cfg.num_layers):
            p = {n: getattr(self, n)[i] for n in STACKED_PARAMS}
            x = _stacked_layer_fwd(p, x, num_heads=cfg.num_heads,
                                   eps=cfg.layer_norm_eps,
                                   kv=cache.layer(i))
        return x


class GPTModel(nn.Module):
    def __init__(self, config: GPTConfig, device=None, dtype=None):
        super().__init__()
        self.config = config
        self.embeddings = GPTEmbeddings(config, device, dtype)
        if config.stacked:
            # as the reference: the stacked decoder, and an empty layer list
            self.decoder = GPTStackedTransformer(config, device, dtype)
            self.layers = nn.ModuleList([])
        else:
            self.layers = nn.ModuleList([GPTDecoderLayer(config, device,
                                                         dtype)
                                         for _ in range(config.num_layers)])
        self.ln_f = nn.LayerNorm(config.hidden_size,
                                 eps=config.layer_norm_eps, device=device,
                                 dtype=dtype)

    def forward(self, input_ids, cache: Optional[GPTKVCache] = None):
        """Uncached: the final hidden states [B, S, hidden].
        Cached: ``(h, (k_pools, v_pools))`` — the pools are the cache's own
        tensors, updated in place."""
        if cache is None:
            h = self.embeddings(input_ids)
            if self.config.stacked:
                return self.ln_f(self.decoder(h))
            for layer in self.layers:
                h = layer(h)
            return self.ln_f(h)
        h = self.embeddings(input_ids, positions=cache.positions)
        if self.config.stacked:
            return self.ln_f(self.decoder(h, cache=cache)), (cache.k,
                                                             cache.v)
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
            if isinstance(module, GPTStackedTransformer):
                module.reset_parameters(g, std)
            elif isinstance(module, nn.Linear):
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
        """Zeroed K/V pools on the model's device, in ``dtype`` (default:
        the model's): per-layer lists of ``[num_pages, page_size, heads,
        head_dim]`` tensors for the module stack, or ONE stacked ``[L,
        num_pages, page_size, heads, head_dim]`` pair for the stacked
        decoder. ``dtype`` may also be the string ``"int8"``: each pool is
        then the ``(int8 values, f32 per-slot-per-head scales [..., page_size,
        heads])`` tuple (ops/paged_attention) — for the stacked decoder one
        tuple of stacked tensors. Page 0 is the trash page and is never
        allocated."""
        cfg = self.config
        shape = (int(num_pages), int(page_size), cfg.num_heads,
                 cfg.hidden_size // cfg.num_heads)
        if cfg.stacked:
            return (self._stacked_pool(shape, dtype),
                    self._stacked_pool(shape, dtype))
        if isinstance(dtype, str):
            if dtype == "int8":
                mk = [(torch.zeros(shape, dtype=torch.int8,
                                   device=self.device),
                       torch.zeros(shape[:-1], dtype=torch.float32,
                                   device=self.device))
                      for _ in range(2 * cfg.num_layers)]
                return mk[:cfg.num_layers], mk[cfg.num_layers:]
            dtype = getattr(torch, dtype)
        dt = dtype or self.dtype
        mk = [torch.zeros(shape, dtype=dt, device=self.device)
              for _ in range(2 * cfg.num_layers)]
        return mk[:cfg.num_layers], mk[cfg.num_layers:]

    def _stacked_pool(self, shape, dtype):
        shape = (self.config.num_layers,) + shape
        if isinstance(dtype, str) and dtype == "int8":
            return (torch.zeros(shape, dtype=torch.int8, device=self.device),
                    torch.zeros(shape[:-1], dtype=torch.float32,
                                device=self.device))
        if isinstance(dtype, str):
            dtype = getattr(torch, dtype)
        return torch.zeros(shape, dtype=dtype or self.dtype,
                           device=self.device)

    def kv_cache_spec(self, kv_dtype: str = "") -> dict:
        """Geometry the decode engine sizes its cache from."""
        cfg = self.config
        nh, hd = cfg.num_heads, cfg.hidden_size // cfg.num_heads
        per_token = cfg.num_layers * 2 * kv_pool_bytes(
            1, 1, nh, hd, kv_dtype or None)
        return {"num_layers": cfg.num_layers, "num_heads": nh,
                "head_dim": hd, "max_seq_len": cfg.max_seq_len,
                "stacked": bool(cfg.stacked), "kv_dtype": kv_dtype or "",
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
