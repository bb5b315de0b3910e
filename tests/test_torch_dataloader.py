"""Port parity for the input pipeline: ``paddle_tpu_torch.io`` (datasets,
samplers, ``DataLoader`` with worker processes over the port's own
shared-memory ring) against ``paddle_tpu.io`` on the CPU.

Batches are compared element for element (integer and float32 data pass
through both loaders unchanged). A ``TrainStep`` fed by each package's
loader is held at ``test_torch_train``'s float32 rule (rtol 2e-4 / atol
2e-5). Two worker processes at most, small datasets.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.io as jio
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.models import GPTPretrainingCriterion as JCriterion
from paddle_tpu_torch import io as pio
from paddle_tpu_torch.framework import random as random_mod
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import GPTPretrainingCriterion
from paddle_tpu_torch.native import shm_ring
from paddle_tpu_torch.optimizer import AdamW
from test_torch_train import (_arrays, _assert_matches, _jax_grads, _jax_model,
                              _port_model)
from torch_threads import two_intra_op_threads  # noqa: F401 (autouse)

N, F = 22, 5
# every loader with workers gives up after this long without a batch, so a
# stuck worker fails its test instead of stalling the run
WAIT_S = 60


def _arrays_xy(seed=0):
    rng = np.random.RandomState(seed)
    return rng.randn(N, F).astype(np.float32), np.arange(N, dtype=np.int64)


def _np(batch):
    """A batch of either package (one tensor, or a list of them) as a list
    of numpy arrays."""
    if not isinstance(batch, (list, tuple)):
        batch = [batch]
    return [np.asarray(b.numpy() if hasattr(b, "numpy") else b)
            for b in batch]


def _batches(loader):
    return [_np(b) for b in loader]


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert len(x) == len(y)
        for u, v in zip(x, y):
            np.testing.assert_array_equal(u, v)


class Tokens:
    """bench.py's TokenDataset: sample i is RandomState(i)'s tokens."""

    def __init__(self, n, vocab=256, seq=24):
        self.n, self.vocab, self.seq = n, vocab, seq

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return np.random.RandomState(i).randint(
            0, self.vocab, (self.seq,)).astype("int64")


class Failing:
    def __len__(self):
        return 8

    def __getitem__(self, i):
        if i == 5:
            raise ValueError("sample 5 is broken")
        return np.zeros(3, np.float32)


class WorkerIds:
    def __len__(self):
        return 12

    def __getitem__(self, i):
        info = pio.get_worker_info()
        return np.array([info.id, info.num_workers, np.random.randint(
            0, 2 ** 30)], np.int64)


class Big:
    """Samples of 3 MB: a batch of 4 (12 MB) exceeds a ring slot (8 MB)."""

    def __len__(self):
        return 8

    def __getitem__(self, i):
        return np.full(3 << 18, i, np.float32)


@pytest.mark.parametrize("workers", [0, 2])
@pytest.mark.parametrize("drop_last", [False, True])
def test_tensor_dataset_batches_match_reference(workers, drop_last):
    x, y = _arrays_xy()
    want = _batches(jio.DataLoader(jio.TensorDataset([x, y]), batch_size=4,
                                   drop_last=drop_last, num_workers=workers,
                                   timeout=WAIT_S))
    loader = pio.DataLoader(pio.TensorDataset([x, y]), batch_size=4,
                            drop_last=drop_last, num_workers=workers,
                            timeout=WAIT_S)
    got = [b for b in loader]
    assert all(isinstance(t, torch.Tensor) and t.device.type == "cpu"
               for b in got for t in b)
    _same([_np(b) for b in got], want)
    assert len(loader) == len(want) == (N // 4 if drop_last else -(-N // 4))
    if workers:
        # every batch crossed the shared-memory ring, none the queue
        assert (loader.ring_pushes, loader.queue_payloads) == (len(want), 0)


@pytest.mark.parametrize("workers", [0, 2])
def test_subset_concat_compose_chain_match_reference(workers):
    x, y = _arrays_xy(1)
    idx = [3, 17, 4, 9, 0, 21, 11]
    for jds, pds in (
            (jio.Subset(jio.TensorDataset([x, y]), idx),
             pio.Subset(pio.TensorDataset([x, y]), idx)),
            (jio.ConcatDataset([jio.TensorDataset([x[:5], y[:5]]),
                                jio.TensorDataset([x[5:], y[5:]])]),
             pio.ConcatDataset([pio.TensorDataset([x[:5], y[:5]]),
                                pio.TensorDataset([x[5:], y[5:]])])),
            (jio.ComposeDataset([jio.TensorDataset([x]),
                                 jio.TensorDataset([y])]),
             pio.ComposeDataset([pio.TensorDataset([x]),
                                 pio.TensorDataset([y])]))):
        _same(_batches(pio.DataLoader(pds, batch_size=3, timeout=WAIT_S,
                                      num_workers=workers)),
              _batches(jio.DataLoader(jds, batch_size=3, timeout=WAIT_S,
                                      num_workers=workers)))
    chain = [x[i] for i in range(N)]
    _same(_batches(pio.DataLoader(pio.ChainDataset([chain[:7], chain[7:]]),
                                  batch_size=4)),
          _batches(jio.DataLoader(jio.ChainDataset([chain[:7], chain[7:]]),
                                  batch_size=4)))


def test_samplers_draw_from_the_port_generator():
    x, y = _arrays_xy(2)
    ds = pio.TensorDataset([x, y])
    random_mod.seed(3)
    a = [b[1].tolist() for b in pio.DataLoader(ds, batch_size=5,
                                               shuffle=True)]
    random_mod.seed(3)
    b = [b[1].tolist() for b in pio.DataLoader(ds, batch_size=5,
                                               shuffle=True)]
    assert a == b and sorted(sum(a, [])) == list(range(N))
    assert sum(a, []) != list(range(N))
    parts = pio.random_split(ds, [10, 12], generator=random_mod.Generator(4))
    seen = sorted(int(p[i][1]) for p in parts for i in range(len(p)))
    assert seen == list(range(N)) and [len(p) for p in parts] == [10, 12]
    w = list(pio.WeightedRandomSampler([0.0, 1.0, 0.0, 3.0], 50,
                                       generator=random_mod.Generator(5)))
    assert set(w) <= {1, 3} and w.count(3) > w.count(1)
    shards = [list(pio.DistributedBatchSampler(ds, 4, num_replicas=2, rank=r))
              for r in range(2)]
    jshards = [list(jio.DistributedBatchSampler(ds, 4, num_replicas=2,
                                                rank=r)) for r in range(2)]
    assert shards == jshards


def test_workers_are_told_who_they_are_and_seeded():
    assert pio.get_worker_info() is None
    def rows():
        return np.concatenate([b[0] for b in _batches(pio.DataLoader(
            WorkerIds(), batch_size=3, num_workers=2, timeout=WAIT_S))])
    random_mod.seed(6)
    a = rows()
    random_mod.seed(6)
    b = rows()
    # batch i goes to worker i % 2; both report 2 workers
    np.testing.assert_array_equal(a[:, 0], np.repeat([0, 1, 0, 1], 3))
    assert (a[:, 1] == 2).all()
    # numpy is seeded per worker from the port's generator: reproducible,
    # and the two workers' streams differ
    np.testing.assert_array_equal(a, b)
    assert a[0, 2] != a[3, 2]


def test_worker_exception_is_raised_in_the_parent():
    loader = pio.DataLoader(Failing(), batch_size=2, num_workers=2,
                            timeout=WAIT_S)
    with pytest.raises(RuntimeError, match="sample 5 is broken"):
        list(loader)


def test_payload_larger_than_a_ring_slot_takes_the_queue():
    """The reference's transport rule: a batch that does not fit a ring
    slot goes through the worker's queue, and is counted there."""
    loader = pio.DataLoader(Big(), batch_size=4, num_workers=2,
                            timeout=WAIT_S)
    got = list(loader)
    assert (loader.ring_pushes, loader.queue_payloads) == (0, 2)
    assert float(got[1][-1, 0]) == 7.0
    small = pio.DataLoader(Big(), batch_size=2, num_workers=2,
                           timeout=WAIT_S)
    assert len(list(small)) == 4
    assert (small.ring_pushes, small.queue_payloads) == (4, 0)


def test_ring_round_trip_and_refusal():
    ring = shm_ring.ShmRing(f"/ptt_test_{id(object())}", owner=True,
                            n_slots=2, slot_bytes=64)
    try:
        assert ring.push(b"abc") and ring.push(b"x" * 56)
        assert not ring.push(b"y" * 57)            # larger than a slot
        assert ring.pop(timeout_ms=100) == b"abc"
        assert ring.pop(timeout_ms=100) == b"x" * 56
        with pytest.raises(TimeoutError):
            ring.pop(timeout_ms=1)
        ring.close()
        with pytest.raises(BrokenPipeError):
            ring.push(b"z")
    finally:
        ring.free()


def test_train_step_fed_by_the_loader_matches_reference():
    """Three AdamW steps of gpt_tiny, each on the next batch of a token
    dataset read by two workers, equal the reference fed by its loader;
    elements whose reference gradient is rounding noise are held to Adam's
    bound (``_assert_matches`` with the reference's gradients)."""
    ds_n, steps = 6, 3
    jm = _jax_model()
    init = _arrays(jm)
    jcrit = JCriterion()
    jopt = paddle.optimizer.AdamW(learning_rate=1e-4,
                                  parameters=jm.parameters())
    jstep = JTrainStep(jm, lambda o, y: jcrit(o, y), jopt)
    jl, grads = [], []
    for b in jio.DataLoader(Tokens(ds_n), batch_size=2, num_workers=2,
                            timeout=WAIT_S):
        b = b if isinstance(b, paddle.Tensor) else b[0]
        grads.append(_jax_grads(jm, jcrit(jm(b), b)))
        jl.append(float(jstep(b, b).numpy()))
    pm = _port_model(init)
    pcrit = GPTPretrainingCriterion()
    popt = AdamW(learning_rate=1e-4, parameters=pm.named_parameters())
    pstep = TrainStep(pm, lambda o, y: pcrit(o, y), popt)
    loader = pio.DataLoader(Tokens(ds_n), batch_size=2, num_workers=2,
                            timeout=WAIT_S)
    pl = [float(pstep(b, b)) for b in loader]
    assert len(pl) == len(jl) == steps
    assert (loader.ring_pushes, loader.queue_payloads) == (steps, 0)
    from paddle_tpu_torch import convert
    _assert_matches("loader-fed steps", (pl, convert.export_jax_state(pm)),
                    (jl, _arrays(jm)), init, steps=steps, grads=grads)


def test_ring_library_is_the_ports_own_build():
    """The ring the port loads is built from the port's own source into
    the port's build directory, never the JAX package's native library."""
    from paddle_tpu_torch import native
    lib = native.host_library()
    pkg = native._PKG
    assert all(src.is_relative_to(pkg / "csrc" / "host")
               for src in native.SOURCES)
    assert lib._name.startswith(str(native.BUILD_DIR))
    assert "paddle_tpu_native" not in lib._name
