"""ERNIE encoder family (the port of ``paddle_tpu/models/ernie.py``): the
BERT blocks of ``models/bert.py`` with ERNIE's task-type embeddings, added
after the embeddings' layer norm and dropout, as the reference adds them.
``ernie_3_0_10b`` is the BASELINE config-5 scale (48 layers, hidden 4096,
32 heads of 128); on one card it runs its forward (about 20 GB of bf16
weights, built on the device in bf16), while training it needs its weights
sharded over cards (ROADMAP queue 1 item 5c, part 2)."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from ..framework.device import resolve_device
from ..nn.layer.common import Dropout
from .bert import (BertConfig, BertEmbeddings, BertLayer, BertPooler,
                   _Encoder, run_encoder)

__all__ = ["ErnieConfig", "ErnieModel", "ErnieForSequenceClassification",
           "ernie_tiny", "ernie_base", "ernie_3_0_10b"]

ErnieConfig = BertConfig


def ernie_tiny(**kw) -> ErnieConfig:
    d = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
             intermediate_size=128, max_position_embeddings=128,
             hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    d.update(kw)
    return ErnieConfig(**d)


def ernie_base(**kw) -> ErnieConfig:
    return ErnieConfig(**kw)


def ernie_3_0_10b(**kw) -> ErnieConfig:
    """~10B-parameter preset (BASELINE config 5 scale)."""
    d = dict(vocab_size=50304, hidden_size=4096, num_layers=48,
             num_heads=32, intermediate_size=16384,
             max_position_embeddings=2048)
    d.update(kw)
    return ErnieConfig(**d)


class ErnieModel(_Encoder):
    """BERT-style encoder + ERNIE task-type embedding."""

    def __init__(self, config: ErnieConfig, task_type_vocab_size: int = 16,
                 *, device=None, dtype: torch.dtype = torch.float32,
                 seed: Optional[int] = 0):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        self.embeddings = BertEmbeddings(config, device, dtype)
        self.task_type_embeddings = nn.Parameter(torch.empty(
            task_type_vocab_size, config.hidden_size, device=device,
            dtype=dtype))
        self.encoder = nn.ModuleList([BertLayer(config, device, dtype)
                                      for _ in range(config.num_layers)])
        self.pooler = BertPooler(config, device, dtype)
        self.reset_parameters(seed)

    def forward(self, input_ids, token_type_ids=None, task_type_ids=None,
                attention_mask=None):
        h = self.embeddings(input_ids, token_type_ids)
        if task_type_ids is not None:
            h = h + F.embedding(task_type_ids, self.task_type_embeddings)
        h = run_encoder(self.encoder, h, attention_mask,
                        self.config.recompute)
        return h, self.pooler(h)


class ErnieForSequenceClassification(_Encoder):
    def __init__(self, config: ErnieConfig, num_classes: int = 2, *,
                 device=None, dtype: torch.dtype = torch.float32,
                 seed: Optional[int] = 0):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        self.ernie = ErnieModel(config, device=device, dtype=dtype,
                                seed=None)
        self.dropout = Dropout(config.hidden_dropout_prob)
        self.classifier = nn.Linear(config.hidden_size, num_classes,
                                    device=device, dtype=dtype)
        self.reset_parameters(seed)

    def forward(self, input_ids, token_type_ids=None, task_type_ids=None,
                attention_mask=None):
        _, pooled = self.ernie(input_ids, token_type_ids, task_type_ids,
                               attention_mask)
        return self.classifier(self.dropout(pooled))
