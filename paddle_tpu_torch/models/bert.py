"""BERT encoder family (the port of ``paddle_tpu/models/bert.py``).

Same presets, module tree and parameter names as the reference
(``bert.embeddings.word_embeddings.weight``,
``bert.encoder.{i}.attn.qkv_proj.weight``, ``transform_ln.bias``, ...), so
``convert.py`` carries weights across by name: the reference's
Column/RowParallelLinear and Linear layers are ``nn.Linear`` here (weights
transposed by ``convert.py``), its VocabParallelEmbedding an
``nn.Embedding``, and the position and token-type tables raw parameters, as
the reference's.

Post-LN encoder blocks with tanh-approximate GELU, a head-major fused qkv
(``[b, s, heads, 3, head_dim]``, ``bert.py:118-121``) whose strided q/k/v
views the flash kernels read without a copy, and an MLM decoder tied to the
word embeddings (``h @ wᵀ``, no bias). Attention goes through the port's
``nn.functional.scaled_dot_product_attention`` with ``is_causal=False``,
routed as the reference routes it: without a mask and without dropout to
the bidirectional flash kernels (forward, dq and dk/dv: ``ops/``), with an
additive ``attention_mask`` (``[B, 1, 1, S]``, say) or probability dropout
in training to the reference's dense path. ``BertConfig.recompute`` wraps
each encoder layer in ``distributed.fleet.utils.recompute``, which replays
the port generator's dropout masks in the backward.

Models are built on ``device`` (default: the CUDA device; ``device="cpu"``
or ``"meta"`` must be asked for) in ``dtype``, every weight drawn from a
``torch.Generator`` seeded with ``seed``: projections and tables
N(0, initializer_range), biases 0, layer norms 1/0. A ``meta`` model holds
shapes only and draws nothing. The encoder inside a task model is built
with ``seed=None``, which draws nothing: the task model draws every weight
once, its encoder's included.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from ..distributed.fleet.meta_parallel.mp_layers import mark_megatron
from ..distributed.fleet.utils import recompute
from ..framework.device import resolve_device
from ..nn.functional.attention import scaled_dot_product_attention
from ..nn.functional.loss import cross_entropy
from ..nn.layer.common import Dropout

__all__ = ["BertConfig", "BertEmbeddings", "BertSelfAttention", "BertLayer",
           "BertPooler", "BertModel", "BertForPretraining",
           "BertForSequenceClassification", "BertPretrainingCriterion",
           "bert_tiny", "bert_base"]

# raw embedding tables (parameters of their own, not nn.Embedding)
_TABLES = ("position_embeddings", "token_type_embeddings",
           "task_type_embeddings")


@dataclass
class BertConfig:
    vocab_size: int = 30528          # multiple of 64
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    layer_norm_eps: float = 1e-12
    initializer_range: float = 0.02
    # False: the attention's plain versions instead of the flash kernels
    # (the reference's dense maths)
    use_flash_attention: bool = True
    # recompute each encoder layer in the backward (distributed.fleet.utils
    # .recompute), as the reference's jax.checkpoint around each block
    recompute: bool = False

    def __post_init__(self):
        if self.hidden_size % self.num_heads:
            raise ValueError(f"hidden_size {self.hidden_size} is not a "
                             f"multiple of num_heads {self.num_heads}")


def bert_tiny(**kw) -> BertConfig:
    d = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
             intermediate_size=128, max_position_embeddings=128,
             hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    d.update(kw)
    return BertConfig(**d)


def bert_base(**kw) -> BertConfig:
    return BertConfig(**kw)


@torch.no_grad()
def init_encoder_weights(model: nn.Module, seed: int, std: float) -> None:
    """Draw ``model``'s weights from a generator seeded with ``seed`` (see
    the module docstring); a ``meta`` model is left as it is."""
    dev = next(model.parameters()).device
    if dev.type == "meta":
        return
    g = torch.Generator(device=dev).manual_seed(int(seed))
    for module in model.modules():
        if isinstance(module, (nn.Linear, nn.Embedding)):
            module.weight.normal_(0.0, std, generator=g)
            if getattr(module, "bias", None) is not None:
                module.bias.zero_()
        elif isinstance(module, nn.LayerNorm):
            module.weight.fill_(1.0)
            module.bias.zero_()
    for name, p in model.named_parameters():
        if name.rsplit(".", 1)[-1] in _TABLES:
            p.normal_(0.0, std, generator=g)


class BertEmbeddings(nn.Module):
    def __init__(self, cfg: BertConfig, device=None, dtype=None):
        super().__init__()
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size,
                                            device=device, dtype=dtype)
        self.position_embeddings = nn.Parameter(torch.empty(
            cfg.max_position_embeddings, cfg.hidden_size, device=device,
            dtype=dtype))
        self.token_type_embeddings = nn.Parameter(torch.empty(
            cfg.type_vocab_size, cfg.hidden_size, device=device,
            dtype=dtype))
        self.layer_norm = nn.LayerNorm(cfg.hidden_size,
                                       eps=cfg.layer_norm_eps,
                                       device=device, dtype=dtype)
        self.dropout = Dropout(cfg.hidden_dropout_prob)
        # the reference's word table is a VocabParallelEmbedding
        mark_megatron(self)

    def forward(self, input_ids, token_type_ids=None):
        seq = input_ids.shape[-1]
        h = self.word_embeddings(input_ids)
        h = h + self.position_embeddings[:seq]
        if token_type_ids is not None:
            h = h + F.embedding(token_type_ids, self.token_type_embeddings)
        return self.dropout(self.layer_norm(h))


class BertSelfAttention(nn.Module):
    """Bidirectional fused-qkv attention. ``use_kernels`` (an attribute,
    ``config.use_flash_attention`` at first) picks the flash kernels or
    their plain versions for the maskless path."""

    def __init__(self, cfg: BertConfig, device=None, dtype=None):
        super().__init__()
        self.num_heads = cfg.num_heads
        self.head_dim = cfg.hidden_size // cfg.num_heads
        self.hidden = cfg.hidden_size
        self.use_kernels = cfg.use_flash_attention
        self.attn_dropout_p = cfg.attention_probs_dropout_prob
        self.qkv_proj = nn.Linear(cfg.hidden_size, 3 * cfg.hidden_size,
                                  device=device, dtype=dtype)
        self.out_proj = nn.Linear(cfg.hidden_size, cfg.hidden_size,
                                  device=device, dtype=dtype)

    def forward(self, x, attn_mask=None):
        b, s, _ = x.shape
        qkv = self.qkv_proj(x).view(b, s, self.num_heads, 3, self.head_dim)
        q, k, v = qkv.unbind(3)    # one stacked gradient, not three
        out = scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask, dropout_p=self.attn_dropout_p,
            is_causal=False, training=self.training,
            use_kernels=self.use_kernels)
        return self.out_proj(out.reshape(b, s, self.hidden))


class BertLayer(nn.Module):
    """Post-LN encoder block (classic BERT ordering)."""

    def __init__(self, cfg: BertConfig, device=None, dtype=None):
        super().__init__()
        eps = cfg.layer_norm_eps
        self.attn = BertSelfAttention(cfg, device, dtype)
        self.ln1 = nn.LayerNorm(cfg.hidden_size, eps=eps, device=device,
                                dtype=dtype)
        self.fc_in = nn.Linear(cfg.hidden_size, cfg.intermediate_size,
                               device=device, dtype=dtype)
        self.fc_out = nn.Linear(cfg.intermediate_size, cfg.hidden_size,
                                device=device, dtype=dtype)
        self.ln2 = nn.LayerNorm(cfg.hidden_size, eps=eps, device=device,
                                dtype=dtype)
        self.dropout = Dropout(cfg.hidden_dropout_prob)
        # the reference's projections are its tensor-parallel layers
        mark_megatron(self)

    def forward(self, x, attn_mask=None):
        x = self.ln1(x + self.dropout(self.attn(x, attn_mask)))
        # tanh-approximate gelu, as the reference (bert.py:147-152)
        h = self.fc_out(F.gelu(self.fc_in(x), approximate="tanh"))
        return self.ln2(x + self.dropout(h))


class BertPooler(nn.Module):
    def __init__(self, cfg: BertConfig, device=None, dtype=None):
        super().__init__()
        self.dense = nn.Linear(cfg.hidden_size, cfg.hidden_size,
                               device=device, dtype=dtype)

    def forward(self, h):
        return torch.tanh(self.dense(h[:, 0]))


def run_encoder(layers, h, attention_mask, recompute_layers: bool):
    """The encoder stack over ``h``, each layer recomputed in the backward
    when ``recompute_layers`` (reference ``bert.py:177-181``)."""
    for layer in layers:
        h = (recompute(layer, h, attention_mask) if recompute_layers
             else layer(h, attention_mask))
    return h


class _Encoder(nn.Module):
    """Shared by the top-level models: their weights' draw and size."""

    def reset_parameters(self, seed: Optional[int] = 0) -> None:
        """Draw every weight from ``seed``; ``None`` draws nothing."""
        if seed is not None:
            init_encoder_weights(self, seed, self.config.initializer_range)

    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())


class BertModel(_Encoder):
    def __init__(self, config: BertConfig, *, device=None,
                 dtype: torch.dtype = torch.float32,
                 seed: Optional[int] = 0):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        self.embeddings = BertEmbeddings(config, device, dtype)
        self.encoder = nn.ModuleList([BertLayer(config, device, dtype)
                                      for _ in range(config.num_layers)])
        self.pooler = BertPooler(config, device, dtype)
        self.reset_parameters(seed)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        h = run_encoder(self.encoder, self.embeddings(input_ids,
                                                      token_type_ids),
                        attention_mask, self.config.recompute)
        return h, self.pooler(h)


class BertForPretraining(_Encoder):
    """MLM + NSP heads, the word embeddings tied to the MLM decoder."""

    def __init__(self, config: BertConfig, *, device=None,
                 dtype: torch.dtype = torch.float32,
                 seed: Optional[int] = 0):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        self.bert = BertModel(config, device=device, dtype=dtype, seed=None)
        h = config.hidden_size
        self.transform = nn.Linear(h, h, device=device, dtype=dtype)
        self.transform_ln = nn.LayerNorm(h, eps=config.layer_norm_eps,
                                         device=device, dtype=dtype)
        self.nsp_head = nn.Linear(h, 2, device=device, dtype=dtype)
        self.reset_parameters(seed)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        seq_out, pooled = self.bert(input_ids, token_type_ids,
                                    attention_mask)
        h = self.transform_ln(F.gelu(self.transform(seq_out),
                                     approximate="tanh"))
        # the decoder tied to the word embeddings: h @ wᵀ (bert.py:204)
        mlm_logits = F.linear(h, self.bert.embeddings.word_embeddings.weight)
        return mlm_logits, self.nsp_head(pooled)


class BertForSequenceClassification(_Encoder):
    def __init__(self, config: BertConfig, num_classes: int = 2, *,
                 device=None, dtype: torch.dtype = torch.float32,
                 seed: Optional[int] = 0):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        self.bert = BertModel(config, device=device, dtype=dtype, seed=None)
        self.dropout = Dropout(config.hidden_dropout_prob)
        self.classifier = nn.Linear(config.hidden_size, num_classes,
                                    device=device, dtype=dtype)
        self.reset_parameters(seed)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        _, pooled = self.bert(input_ids, token_type_ids, attention_mask)
        return self.classifier(self.dropout(pooled))


class BertPretrainingCriterion(nn.Module):
    """MLM cross entropy (``ignore_index`` for unmasked tokens) plus NSP
    cross entropy (reference ``bert.py:224-239``)."""

    def __init__(self, ignore_index: int = -100):
        super().__init__()
        self.ignore_index = ignore_index

    def forward(self, outputs, mlm_labels, nsp_labels=None):
        mlm_logits, nsp_logits = outputs
        b, s, v = mlm_logits.shape
        loss = cross_entropy(mlm_logits.reshape(b * s, v),
                             mlm_labels.reshape(b * s),
                             ignore_index=self.ignore_index)
        if nsp_labels is not None:
            loss = loss + cross_entropy(nsp_logits, nsp_labels)
        return loss
