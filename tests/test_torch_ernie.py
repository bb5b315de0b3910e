"""Port parity for ERNIE (``models/ernie.py``) against ``paddle_tpu`` on the
CPU: ``ernie_tiny`` with task-type ids, token types and a padding mask at
``test_torch_bert``'s limits (outputs atol 1e-4; two AdamW steps rtol 2e-4 /
atol 2e-5), and ``ernie_3_0_10b``'s parameter count against the reference's,
the port's model built on the ``meta`` device and the reference's under its
``LazyGuard`` (shapes only: ~10 B parameters are never allocated)."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.models.ernie import ErnieForSequenceClassification as JCls
from paddle_tpu.models.ernie import ErnieModel as JErnie
from paddle_tpu.models.ernie import ernie_3_0_10b as j_ernie_10b
from paddle_tpu.models.ernie import ernie_tiny as j_ernie_tiny
from paddle_tpu_torch import convert
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import (ErnieForSequenceClassification,
                                     ErnieModel, ernie_3_0_10b, ernie_tiny)
from paddle_tpu_torch.nn.functional import cross_entropy
from paddle_tpu_torch.optimizer import AdamW
from test_torch_bert import LR, _padding_mask
from test_torch_gpt import ATOL as LOGIT_ATOL
from test_torch_train import _assert_matches
from torch_threads import two_intra_op_threads  # noqa: F401 (autouse)

B, S = 2, 32


def _arrays(jm):
    return {n: np.asarray(p._data) for n, p in jm.named_parameters()}


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 256, (B, S)).astype(np.int64),
            rng.randint(0, 2, (B, S)).astype(np.int64),
            rng.randint(0, 16, (B, S)).astype(np.int64),
            _padding_mask((S, 13)))


@pytest.mark.parametrize("with_task", [True, False],
                         ids=["task_types", "no_task_types"])
def test_model_outputs_match_reference(with_task):
    paddle.seed(0)
    jm = JErnie(j_ernie_tiny(use_flash_attention=False))
    pm = convert.load_jax_state(ErnieModel(ernie_tiny(), device="cpu"),
                                _arrays(jm))
    ids, tt, task, mask = _inputs(1)
    task = task if with_task else None
    jh, jp = jm(paddle.to_tensor(ids), paddle.to_tensor(tt),
                None if task is None else paddle.to_tensor(task),
                paddle.to_tensor(mask))
    h, pooled = pm(torch.from_numpy(ids), torch.from_numpy(tt),
                   None if task is None else torch.from_numpy(task),
                   torch.from_numpy(mask))
    assert h.shape == (B, S, 64) and pooled.shape == (B, 64)
    np.testing.assert_allclose(h.detach().numpy(), np.asarray(jh._data),
                               atol=LOGIT_ATOL, rtol=0)
    np.testing.assert_allclose(pooled.detach().numpy(), np.asarray(jp._data),
                               atol=LOGIT_ATOL, rtol=0)


def test_sequence_classification_steps_match_reference():
    """Two AdamW steps of ErnieForSequenceClassification on (ids, token
    types, task types, padding mask) with class labels, ``n_inputs=4``."""
    paddle.seed(0)
    jm = JCls(j_ernie_tiny(use_flash_attention=False))
    init = _arrays(jm)
    pm = convert.load_jax_state(
        ErnieForSequenceClassification(ernie_tiny(), device="cpu"), init)
    batch = (*_inputs(2), np.array([0, 1], np.int64))
    jopt = paddle.optimizer.AdamW(learning_rate=LR,
                                  parameters=jm.parameters())
    jstep = JTrainStep(jm, lambda o, y: JF.cross_entropy(o, y), jopt)
    jl = [float(jstep(*[paddle.to_tensor(a) for a in batch],
                      n_inputs=4).numpy()) for _ in range(2)]
    popt = AdamW(learning_rate=LR, parameters=pm.named_parameters())
    pstep = TrainStep(pm, lambda o, y: cross_entropy(o, y), popt)
    pl = [float(pstep(*[torch.from_numpy(a) for a in batch], n_inputs=4))
          for _ in range(2)]
    _assert_matches("ernie AdamW", (pl, convert.export_jax_state(pm)),
                    (jl, _arrays(jm)), init, steps=2, lr=LR)


def test_ernie_10b_parameter_count_matches_reference():
    with paddle.LazyGuard():
        jm = JErnie(j_ernie_10b())
    want = sum(int(np.prod(p.shape)) for p in jm.parameters())
    pm = ErnieModel(ernie_3_0_10b(), device="meta")
    assert pm.num_params() == want
    assert 9.8e9 < want < 1.0e10
    names = dict(pm.named_parameters())
    for n, p in jm.named_parameters():
        assert tuple(names[n].shape) == tuple(
            p.shape if p.ndim != 2 or not n.endswith("weight")
            or "word_embeddings" in n else p.shape[::-1]), n
