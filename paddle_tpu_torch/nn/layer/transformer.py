"""Transformer layers: the port of ``paddle_tpu/nn/layer/transformer.py``
(``MultiHeadAttention`` with its caches, the encoder and decoder layers and
stacks, ``Transformer``).

The parameter names are the reference's (``self_attn.q_proj.weight``,
``linear1.weight``, ``norm1.bias``, ...), so state dicts load across. The
attention goes through ``nn.functional.scaled_dot_product_attention`` in
``[B, S, H, D]``, which routes as the reference's: without a mask and
without dropout (``dropout == 0``, or outside training) to the flash path
(the hand-written kernels on the card), otherwise to the dense path. An
encoder layer's ``attn_dropout`` defaults to its ``dropout``, so a training
layer built with the defaults takes the dense path, as the reference's. A
bool mask becomes 0 where True and -1e9 where False, in float32
(``_convert_attention_mask``). ``need_weights=True`` returns ``None`` for
the weights, as the reference's.

Incremental decoding: ``MultiHeadAttention.Cache`` holds the keys and
values so far and each step appends its own along the sequence, so the
query has one row and the keys all of them (the flash forward at ``Sq !=
Sk``); ``StaticCache`` holds a cross-attention's projected memory.
``TransformerEncoder``/``TransformerDecoder`` copy their layer (the
parameters' values, and their ``ParamAttr`` settings) for each of
``num_layers``.
"""
from __future__ import annotations

import collections
import copy

import numpy as np
import torch

from ...core.dispatch import apply_op
from ...tensor import manipulation as M
from .. import functional as F
from .common import Dropout, Linear
from .container import LayerList
from .layers import Layer
from .norm import LayerNorm

__all__ = ["MultiHeadAttention", "TransformerEncoderLayer",
           "TransformerEncoder", "TransformerDecoderLayer",
           "TransformerDecoder", "Transformer"]


def _convert_attention_mask(attn_mask, dtype):
    """A bool mask as an additive float32 one (0 where True, -1e9 where
    False); other masks as they are."""
    if attn_mask is None:
        return None
    data = getattr(attn_mask, "_data", attn_mask)
    if data.dtype == torch.bool:
        return apply_op("where", lambda m: torch.where(
            m, torch.zeros((), device=m.device),
            torch.full((), -1e9, device=m.device)), attn_mask)
    return attn_mask


def _copies(layer, n):
    """``layer`` and ``n - 1`` deep copies of it, each parameter's
    ``ParamAttr`` settings kept (the reference deep-copies its Parameter
    objects whole)."""
    out = [layer]
    for _ in range(n - 1):
        new = copy.deepcopy(layer)
        for p, q in zip(layer.parameters(), new.parameters()):
            q.optimize_attr = dict(p.optimize_attr)
            q.regularizer = p.regularizer
            q.need_clip = p.need_clip
            q.is_bias = p.is_bias
        out.append(new)
    return out


class MultiHeadAttention(Layer):
    Cache = collections.namedtuple("Cache", ["k", "v"])
    StaticCache = collections.namedtuple("StaticCache", ["k", "v"])

    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None,
                 vdim=None, need_weights=False, weight_attr=None,
                 bias_attr=None):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.need_weights = need_weights
        self.dropout = dropout
        self.q_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr)
        self.k_proj = Linear(kdim or embed_dim, embed_dim, weight_attr,
                             bias_attr)
        self.v_proj = Linear(vdim or embed_dim, embed_dim, weight_attr,
                             bias_attr)
        self.out_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr)

    def _heads(self, x):
        return M.reshape(x, [x.shape[0], x.shape[1], self.num_heads,
                             self.head_dim])

    def gen_cache(self, key, value=None, type=None):  # noqa: A002
        """A ``StaticCache`` of ``key``/``value`` projected (``type=
        MultiHeadAttention.StaticCache``), else an empty ``Cache``."""
        if type == MultiHeadAttention.StaticCache:
            return self.StaticCache(self._heads(self.k_proj(key)),
                                    self._heads(self.v_proj(
                                        key if value is None else value)))
        from ...tensor.creation import zeros, zeros_like
        k = zeros([key.shape[0], 0, self.num_heads, self.head_dim],
                  key.dtype)
        return self.Cache(k, zeros_like(k))

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        key = query if key is None else key
        value = key if value is None else value
        q = self._heads(self.q_proj(query))
        if isinstance(cache, self.StaticCache):
            k, v = cache.k, cache.v
        else:
            k = self._heads(self.k_proj(key))
            v = self._heads(self.v_proj(value))
            if isinstance(cache, self.Cache):
                k = M.concat([cache.k, k], axis=1)
                v = M.concat([cache.v, v], axis=1)
                cache = self.Cache(k, v)
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=_convert_attention_mask(attn_mask, q.dtype),
            dropout_p=self.dropout if self.training else 0.0,
            training=self.training)
        out = self.out_proj(M.reshape(out, [out.shape[0], out.shape[1],
                                            self.embed_dim]))
        if cache is not None and not isinstance(cache, self.StaticCache):
            return (out, None, cache) if self.need_weights else (out, cache)
        return (out, None) if self.need_weights else out


class TransformerEncoderLayer(Layer):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 layer_norm_eps=1e-5):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                            weight_attr=weight_attr,
                                            bias_attr=bias_attr)
        self.linear1 = Linear(d_model, dim_feedforward, weight_attr,
                              bias_attr)
        self.dropout = Dropout(act_dropout)
        self.linear2 = Linear(dim_feedforward, d_model, weight_attr,
                              bias_attr)
        self.norm1 = LayerNorm(d_model, layer_norm_eps)
        self.norm2 = LayerNorm(d_model, layer_norm_eps)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.activation = getattr(F, activation)

    def forward(self, src, src_mask=None, cache=None):
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        if cache is None:
            src = self.self_attn(src, src, src, src_mask)
        else:
            src, cache = self.self_attn(src, src, src, src_mask, cache)
        src = residual + self.dropout1(src)
        if not self.normalize_before:
            src = self.norm1(src)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        src = self.linear2(self.dropout(self.activation(self.linear1(src))))
        src = residual + self.dropout2(src)
        if not self.normalize_before:
            src = self.norm2(src)
        return src if cache is None else (src, cache)

    def gen_cache(self, src):
        return self.self_attn.gen_cache(src)


class TransformerEncoder(Layer):
    def __init__(self, encoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList(_copies(encoder_layer, num_layers))
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None, cache=None):
        output, new_caches = src, []
        for i, layer in enumerate(self.layers):
            if cache is None:
                output = layer(output, src_mask)
            else:
                output, new = layer(output, src_mask, cache[i])
                new_caches.append(new)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, src):
        return [layer.gen_cache(src) for layer in self.layers]


class TransformerDecoderLayer(Layer):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 layer_norm_eps=1e-5):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                            weight_attr=weight_attr,
                                            bias_attr=bias_attr)
        self.cross_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                             weight_attr=weight_attr,
                                             bias_attr=bias_attr)
        self.linear1 = Linear(d_model, dim_feedforward, weight_attr,
                              bias_attr)
        self.dropout = Dropout(act_dropout)
        self.linear2 = Linear(dim_feedforward, d_model, weight_attr,
                              bias_attr)
        self.norm1 = LayerNorm(d_model, layer_norm_eps)
        self.norm2 = LayerNorm(d_model, layer_norm_eps)
        self.norm3 = LayerNorm(d_model, layer_norm_eps)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.dropout3 = Dropout(dropout)
        self.activation = getattr(F, activation)

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        residual = tgt
        if self.normalize_before:
            tgt = self.norm1(tgt)
        if cache is None:
            tgt = self.self_attn(tgt, tgt, tgt, tgt_mask)
        else:
            tgt, incr = self.self_attn(tgt, tgt, tgt, tgt_mask, cache[0])
        tgt = residual + self.dropout1(tgt)
        if not self.normalize_before:
            tgt = self.norm1(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm2(tgt)
        if cache is None:
            tgt = self.cross_attn(tgt, memory, memory, memory_mask)
        else:
            tgt = self.cross_attn(tgt, memory, memory, memory_mask, cache[1])
            if isinstance(tgt, tuple):
                tgt = tgt[0]
        tgt = residual + self.dropout2(tgt)
        if not self.normalize_before:
            tgt = self.norm2(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm3(tgt)
        tgt = self.linear2(self.dropout(self.activation(self.linear1(tgt))))
        tgt = residual + self.dropout3(tgt)
        if not self.normalize_before:
            tgt = self.norm3(tgt)
        return tgt if cache is None else (tgt, (incr, cache[1]))

    def gen_cache(self, memory):
        """``(the self-attention's empty Cache, the cross-attention's
        StaticCache of memory)``."""
        return (self.self_attn.gen_cache(memory),
                self.cross_attn.gen_cache(memory, memory,
                                          MultiHeadAttention.StaticCache))


class TransformerDecoder(Layer):
    def __init__(self, decoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList(_copies(decoder_layer, num_layers))
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        output, new_caches = tgt, []
        for i, layer in enumerate(self.layers):
            if cache is None:
                output = layer(output, memory, tgt_mask, memory_mask)
            else:
                output, new = layer(output, memory, tgt_mask, memory_mask,
                                    cache[i])
                new_caches.append(new)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, memory, do_zip=False):
        caches = [layer.gen_cache(memory) for layer in self.layers]
        return list(zip(*caches)) if do_zip else caches


class Transformer(Layer):
    def __init__(self, d_model=512, nhead=8, num_encoder_layers=6,
                 num_decoder_layers=6, dim_feedforward=2048, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 custom_encoder=None, custom_decoder=None):
        super().__init__()
        if custom_encoder is not None:
            self.encoder = custom_encoder
        else:
            layer = TransformerEncoderLayer(
                d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, weight_attr,
                bias_attr)
            self.encoder = TransformerEncoder(
                layer, num_encoder_layers,
                LayerNorm(d_model) if normalize_before else None)
        if custom_decoder is not None:
            self.decoder = custom_decoder
        else:
            layer = TransformerDecoderLayer(
                d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, weight_attr,
                bias_attr)
            self.decoder = TransformerDecoder(
                layer, num_decoder_layers,
                LayerNorm(d_model) if normalize_before else None)
        self.d_model = d_model
        self.nhead = nhead

    def forward(self, src, tgt, src_mask=None, tgt_mask=None,
                memory_mask=None):
        memory = self.encoder(src, src_mask)
        return self.decoder(tgt, memory, tgt_mask, memory_mask)

    @staticmethod
    def generate_square_subsequent_mask(length):
        """``[length, length]`` float32: 0 on and below the diagonal, -inf
        above."""
        from ...core.tensor import to_tensor
        return to_tensor(np.triu(np.full((length, length), -np.inf,
                                         np.float32), k=1))
