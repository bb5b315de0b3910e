"""The Paddle-style encoder classifier (``test_torch_paddle_encoder_script.
py``) in bf16 O2 (``amp.decorate`` + ``amp.auto_cast(level="O2")``) under
both packages, from the same initial weights: the port's distance from the
JAX float32 run (losses; L2 over the parameters) within 1.5x the JAX bf16
run's own."""
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from test_torch_paddle_encoder_script import (SMALL, _arrays, _packages,
                                              batches_for, build_model,
                                              train_script)


def test_script_bf16_o2_within_jax_rounding_floor():
    jp, tp = _packages()
    batches = batches_for(SMALL, 2)
    init = _arrays(build_model(jp, SMALL))
    # the two JAX runs compile their ops concurrently (XLA compiles outside
    # the interpreter lock; the reference's AMP and grad state are per
    # thread)
    with ThreadPoolExecutor(2) as pool:
        f32 = pool.submit(train_script, jp, SMALL, 3, 0, batches, init=init)
        bf16 = pool.submit(train_script, jp, SMALL, 3, 0, batches,
                           amp="bfloat16", init=init)
        (jl, jm, _), (jbl, jbm, _) = f32.result(), bf16.result()
    pbl, pbm, _ = train_script(tp, SMALL, 3, 0, batches, amp="bfloat16",
                               init=init)
    ref = _arrays(jm)

    def l2(arrs):
        return float(np.sqrt(sum(((arrs[n].astype(np.float64) - ref[n])
                                  ** 2).sum() for n in ref)))
    loss_j = max(abs(a - b) for a, b in zip(jbl, jl))
    loss_p = max(abs(a - b) for a, b in zip(pbl, jl))
    assert 0 < loss_j and loss_p <= 1.5 * loss_j, (loss_p, loss_j)
    assert l2(_arrays(pbm)) <= 1.5 * l2(_arrays(jbm))
    assert str(pbm.word_embeddings.weight.dtype) == "bfloat16"
