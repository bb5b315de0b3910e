"""``paddle.Model`` under ``amp_configs="O2"`` against the JAX package's:
the encoder classifier of ``test_torch_api_hapi.py``, six steps of
``fit`` in float32 and in O2 from the same weights in each package; the
port's O2 distance from its float32 run is held to the rounding floor,
1.5x the JAX package's own O2 distance from its float32 run, on the
losses and on the parameters' L2."""
import numpy as np

from test_torch_api_hapi import (CFG, TRAIN_BATCHES, _arrays, _setup,
                                 make_model, samples)
from torch_threads import two_intra_op_threads  # noqa: F401 (autouse)


def test_o2_within_the_rounding_floor():
    """``amp_configs="O2"`` (bf16 forward, the GradScaler): the port's
    distance from its float32 run, on the losses and the parameters' L2,
    within 1.5x the JAX package's own O2 distance from its float32 run."""
    script, jp, tp, init = _setup()
    dist = {}
    for P in (jp, tp):
        res = {}
        for amp in (None, "O2"):
            model = make_model(P, script, CFG, init=init, amp=amp)
            train = samples(P, CFG, TRAIN_BATCHES, 1)
            hist = model.fit(train, batch_size=CFG["batch"], shuffle=False,
                             verbose=0)
            res[amp] = (np.asarray(hist["loss"]), _arrays(model.network))
        (l32, p32), (l16, p16) = res[None], res["O2"]
        dist[P] = (np.abs(l16 - l32).max(), np.sqrt(sum(
            ((p16[n] - p32[n]).astype(np.float64) ** 2).sum()
            for n in p32)))
    for i, what in enumerate(("loss", "params L2")):
        assert dist[tp][i] <= 1.5 * dist[jp][i], (what, dist[tp][i],
                                                  dist[jp][i])
