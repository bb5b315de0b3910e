"""Port parity for ResNet (``vision/models/resnet.py``) and its layers
(``Conv2D``, ``BatchNorm2D``, ``MaxPool2D``, ``AdaptiveAvgPool2D``) against
``paddle_tpu`` on the CPU.

Weights and BatchNorm statistics come from the JAX model through
``convert.py`` (convolution weights untransposed, the linear classifier
transposed); inputs from seeded numpy. ``resnet18`` at 64² and b=2 in
both data formats (at 32² the last stage's planes are 1x1, so its
BatchNorm normalises two values a channel in training, which turns the
packages' float32 rounding differences of ~1e-5 into ~3e-2 wherever the
two nearly agree; at 64² it normalises eight): logits atol 1e-4 (float32,
sums in another order); one ``Momentum`` step at ``test_torch_train``'s
rtol 2e-4 / atol 2e-5 with BatchNorm on its running statistics; the
training-mode backward (batch statistics) of each kind of block against
the reference's, on the same input and upstream gradient, at rtol/atol
2e-5, and the whole model's training-mode gradients against float64 in
addition (the two packages' forwards differ by ~1e-5 at the second stage,
enough to put one element of ``layer2.1``'s residual sum on the other
side of its ReLU, which moves that block's gradients and every one
upstream by up to a quarter of their largest: a discontinuity, not a
fault of either package, so the whole model is not held against the
reference in training mode); the
running statistics after a training forward (Paddle's momentum, the biased
batch variance) at atol 1e-5 of their size. The reference's compiled
``TrainStep`` drops BatchNorm's statistic updates (its traced buffers are
swapped back after the step), so the port's ``TrainStep`` is held against
the reference's eager forward, which applies them, as Paddle does. AMP O2:
BatchNorm runs in float32 (black-listed), its parameters and statistics
stay float32, and the logits are held by the rounding-floor rule
(``test_torch_train.O2_FACTOR``).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu.amp import auto_cast as j_auto_cast
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.vision.models import resnet18 as j_resnet18
from paddle_tpu.vision.models.resnet import BasicBlock as JBasicBlock
from paddle_tpu.vision.models.resnet import (
    BottleneckBlock as JBottleneckBlock)
from paddle_tpu_torch import convert
from paddle_tpu_torch.amp import auto_cast
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.nn import BatchNorm2D, Conv2D
from paddle_tpu_torch.nn.functional import batch_norm, cross_entropy
from paddle_tpu_torch.optimizer import Momentum
from paddle_tpu_torch.vision.models import resnet18, resnet50
from paddle_tpu_torch.vision.models.resnet import BasicBlock, BottleneckBlock
from test_torch_train import O2_FACTOR
from torch_threads import two_intra_op_threads  # noqa: F401 (autouse)

RTOL, ATOL = 2e-4, 2e-5
LOGIT_ATOL = 1e-4
FORMATS = ("NCHW", "NHWC")


def _jax_model(fmt):
    paddle.seed(0)
    return j_resnet18(num_classes=10, data_format=fmt)


def _arrays(jm):
    out = {n: np.asarray(p._data) for n, p in jm.named_parameters()}
    out.update({n: np.asarray(b._data) for n, b in jm.named_buffers()})
    return out


def _port_model(arrays, fmt):
    return convert.load_jax_state(
        resnet18(num_classes=10, data_format=fmt, device="cpu"), arrays)


def _images(fmt, seed=0, b=2, hw=64):
    x = np.random.RandomState(seed).randn(b, 3, hw, hw).astype(np.float32)
    return x if fmt == "NCHW" else np.ascontiguousarray(
        x.transpose(0, 2, 3, 1))


def _labels(seed=0, b=2):
    return np.random.RandomState(seed + 100).randint(0, 10, (b,)).astype(
        np.int64)


def _stats(state):
    return {n: v for n, v in state.items()
            if n.endswith("._mean") or n.endswith("._variance")}


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_logits_match_reference(fmt, train):
    jm = _jax_model(fmt)
    pm = _port_model(_arrays(jm), fmt)
    if not train:
        jm.eval()
        pm.eval()
    x = _images(fmt)
    want = np.asarray(jm(paddle.to_tensor(x)).numpy())
    got = pm(torch.from_numpy(x)).detach().numpy()
    assert got.shape == (2, 10)
    np.testing.assert_allclose(got, want, atol=LOGIT_ATOL, rtol=0)


@pytest.mark.parametrize("fmt", FORMATS)
def test_running_statistics_move_with_paddle_momentum(fmt):
    """One training forward in each package from the same statistics:
    running = 0.9 running + 0.1 batch, the variance the biased one."""
    jm = _jax_model(fmt)
    arrays = _arrays(jm)
    rng = np.random.RandomState(5)
    for n in _stats(arrays):       # start from statistics that are not 0/1
        arrays[n] = (rng.rand(*arrays[n].shape).astype(np.float32) + 0.5)
    for n, b in jm.named_buffers():
        b._data = paddle.to_tensor(arrays[n])._data
    pm = _port_model(arrays, fmt)
    x = _images(fmt, seed=1)
    jm(paddle.to_tensor(x))
    pm(torch.from_numpy(x))
    want = _stats(_arrays(jm))
    got = _stats(convert.export_jax_state(pm))
    assert len(got) == 40
    for n in want:
        assert not np.array_equal(want[n], arrays[n]), n
        np.testing.assert_allclose(got[n], want[n], rtol=1e-5,
                                   atol=1e-5 * np.abs(want[n]).max(),
                                   err_msg=n)


def test_batch_norm_functional_matches_reference_update():
    """``batch_norm`` alone, NHWC, training: output and statistics."""
    rng = np.random.RandomState(3)
    x = rng.randn(4, 5, 6, 8).astype(np.float32) * 3 + 1
    w, b = rng.rand(8).astype(np.float32), rng.randn(8).astype(np.float32)
    m0, v0 = rng.randn(8).astype(np.float32), rng.rand(8).astype(np.float32)
    jmean, jvar = paddle.to_tensor(m0), paddle.to_tensor(v0)
    want = JF.batch_norm(paddle.to_tensor(x), jmean, jvar,
                         paddle.to_tensor(w), paddle.to_tensor(b),
                         training=True, momentum=0.8, data_format="NHWC")
    pmean, pvar = torch.from_numpy(m0.copy()), torch.from_numpy(v0.copy())
    got = batch_norm(torch.from_numpy(x), pmean, pvar, torch.from_numpy(w),
                     torch.from_numpy(b), training=True, momentum=0.8,
                     data_format="NHWC")
    np.testing.assert_allclose(got.numpy(), np.asarray(want.numpy()),
                               atol=1e-5)
    np.testing.assert_allclose(pmean.numpy(), np.asarray(jmean.numpy()),
                               atol=1e-6)
    np.testing.assert_allclose(pvar.numpy(), np.asarray(jvar.numpy()),
                               rtol=1e-5)


@pytest.mark.parametrize("fmt", FORMATS)
def test_momentum_step_matches_reference(fmt):
    """One step of bench.py's optimizer, ``Momentum(0.1, 0.9)``: the loss
    and every parameter after it, with BatchNorm reading its running
    statistics (eval mode; training-mode gradients are held block by
    block against the reference's, and as a whole against float64,
    below)."""
    jm = _jax_model(fmt)
    arrays = _arrays(jm)
    pm = _port_model(arrays, fmt)
    jm.eval()
    pm.eval()
    x, y = _images(fmt, seed=2), _labels(2)
    jopt = paddle.optimizer.Momentum(learning_rate=0.1, momentum=0.9,
                                     parameters=jm.parameters())
    jstep = JTrainStep(jm, lambda o, t: JF.cross_entropy(o, t), jopt)
    jl = [float(jstep(paddle.to_tensor(x), paddle.to_tensor(y)).numpy())]
    popt = Momentum(learning_rate=0.1, momentum=0.9,
                    parameters=pm.named_parameters())
    pstep = TrainStep(pm, lambda o, t: cross_entropy(o, t), popt)
    pl = [float(pstep(torch.from_numpy(x), torch.from_numpy(y)))]
    np.testing.assert_allclose(pl, jl, rtol=RTOL, atol=ATOL)
    want = {n: np.asarray(p._data) for n, p in jm.named_parameters()}
    got = convert.export_jax_state(pm)
    for n in want:
        np.testing.assert_allclose(got[n], want[n], rtol=RTOL, atol=ATOL,
                                   err_msg=n)


def _block_pair(kind, fmt):
    """One block of each package, the port's carrying the reference's
    weights (BatchNorm's scale and shift drawn away from 1 and 0): a
    BasicBlock of stride 1, a BasicBlock and a BottleneckBlock of stride 2
    with their downsample branch, 16 input channels."""
    import paddle_tpu.nn as jnn
    paddle.seed(0)
    block, planes, stride = {"basic": (JBasicBlock, 16, 1),
                             "basic_down": (JBasicBlock, 32, 2),
                             "bottleneck_down": (JBottleneckBlock, 8, 2)}[kind]
    out = planes * block.expansion
    jdown = None if stride == 1 else jnn.Sequential(
        jnn.Conv2D(16, out, 1, stride=stride, bias_attr=False,
                   data_format=fmt),
        jnn.BatchNorm2D(out, data_format=fmt))
    jb = block(16, planes, stride, jdown, data_format=fmt)
    rng = np.random.RandomState(11)
    for n, p in jb.named_parameters():
        if ".bn" in "." + n or n.startswith("downsample.1"):
            p._data = paddle.to_tensor(
                (rng.rand(*p.shape) + 0.5 if n.endswith("weight")
                 else rng.randn(*p.shape)).astype(np.float32))._data
    kw = dict(data_format=fmt, device="cpu")
    pdown = None if stride == 1 else torch.nn.Sequential(
        Conv2D(16, out, 1, stride=stride, bias_attr=False, **kw),
        BatchNorm2D(out, **kw))
    pblock = {JBasicBlock: BasicBlock, JBottleneckBlock: BottleneckBlock}
    pb = pblock[block](16, planes, stride, pdown, **kw)
    return jb, convert.load_jax_state(pb, _arrays(jb))


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("kind", ["basic", "basic_down", "bottleneck_down"])
def test_block_training_backward_matches_reference(kind, fmt):
    """Each block's training-mode backward (BatchNorm on the batch's
    statistics, the path ``bench.py --config resnet50`` trains) against the
    reference's on the same input and the same upstream gradient: the
    gradients of the input and of every parameter, and the block's output,
    at rtol/atol 2e-5."""
    jb, pb = _block_pair(kind, fmt)
    rng = np.random.RandomState(12)
    x = rng.randn(4, 16, 8, 8).astype(np.float32)
    if fmt == "NHWC":
        x = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    px = torch.from_numpy(x.copy()).requires_grad_(True)
    pout = pb(px)
    cot = rng.randn(*pout.shape).astype(np.float32)
    pout.backward(torch.from_numpy(cot))
    jx = paddle.to_tensor(x, stop_gradient=False)
    jout = jb(jx)
    jout.backward(paddle.to_tensor(cot))
    np.testing.assert_allclose(pout.detach().numpy(),
                               np.asarray(jout.numpy()), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(px.grad.numpy(), np.asarray(jx.grad.numpy()),
                               rtol=2e-5, atol=2e-5)
    want = dict(jb.named_parameters())
    got = dict(pb.named_parameters())
    assert sorted(got) == sorted(want)
    for n, p in got.items():
        np.testing.assert_allclose(p.grad.numpy(),
                                   np.asarray(want[n].grad.numpy()),
                                   rtol=2e-5, atol=2e-5, err_msg=n)


def test_training_gradients_match_float64():
    """Training-mode gradients (batch statistics) of the float32 model
    against the same model in float64, within 1e-4 of each parameter's
    largest gradient (chip_smoke.py's training parity rule; read 1.3e-5).
    The reference is not the yardstick here: its forward agrees with the
    port's to 1e-5, but on this input that difference flips one ReLU of
    ``layer2.1`` (``out + identity`` within 1e-5 of zero), so its
    gradients from that block up differ from float64 by up to 0.14
    (``layer2.1.conv2.weight``, whose largest is 0.36). Each block's
    backward, fed the same input and upstream gradient, is held against the
    reference's in ``test_block_training_backward_matches_reference``."""
    jm = _jax_model("NCHW")
    arrays = _arrays(jm)
    x, y = _images("NCHW", seed=2), _labels(2)
    grads = {}
    for dt in (torch.float32, torch.float64):
        pm = _port_model(arrays, "NCHW").to(dt)
        cross_entropy(pm(torch.from_numpy(x).to(dt)),
                      torch.from_numpy(y)).backward()
        grads[dt] = {n: p.grad.double() for n, p in pm.named_parameters()}
    for n, want in grads[torch.float64].items():
        err = float((grads[torch.float32][n] - want).abs().max())
        assert err <= 1e-4 * float(want.abs().max()), (n, err)


def test_train_step_advances_statistics_as_the_eager_forward():
    """TrainStep (``__call__`` and ``run_steps``) moves BatchNorm's running
    statistics as the reference's eager training forward moves them; the
    update reads the step's input before the parameters move."""
    jm = _jax_model("NHWC")
    arrays = _arrays(jm)
    pm = _port_model(arrays, "NHWC")
    x, y = _images("NHWC", seed=4), _labels(4)
    jm(paddle.to_tensor(x))        # the eager forward applies the update
    want = _stats(_arrays(jm))
    step = TrainStep(pm, lambda o, t: cross_entropy(o, t),
                     Momentum(learning_rate=0.1, momentum=0.9,
                              parameters=pm.named_parameters()))
    step(torch.from_numpy(x), torch.from_numpy(y))
    got = _stats(convert.export_jax_state(pm))
    for n in want:
        np.testing.assert_allclose(got[n], want[n], rtol=1e-5,
                                   atol=1e-5 * np.abs(want[n]).max(),
                                   err_msg=n)
    step.run_steps(2, torch.from_numpy(x), torch.from_numpy(y))
    after = _stats(convert.export_jax_state(pm))
    assert all(not np.array_equal(after[n], got[n]) for n in got)


def test_eval_mode_uses_running_statistics():
    """In eval mode the output depends on the running statistics and not
    on the batch: the same image alone or beside another gives the same
    logits, equal to the reference's with the same statistics."""
    jm = _jax_model("NCHW")
    arrays = _arrays(jm)
    rng = np.random.RandomState(7)
    for n in _stats(arrays):
        arrays[n] = rng.rand(*arrays[n].shape).astype(np.float32) + 0.5
    for n, b in jm.named_buffers():
        b._data = paddle.to_tensor(arrays[n])._data
    pm = _port_model(arrays, "NCHW").eval()
    jm.eval()
    x = _images("NCHW", seed=8)
    both = pm(torch.from_numpy(x)).detach()
    alone = pm(torch.from_numpy(x[:1])).detach()
    np.testing.assert_allclose(alone.numpy(), both[:1].numpy(), atol=1e-5)
    want = np.asarray(jm(paddle.to_tensor(x)).numpy())
    np.testing.assert_allclose(both.numpy(), want, atol=LOGIT_ATOL)
    got = _stats(convert.export_jax_state(pm))
    for n in got:                   # eval leaves the statistics alone
        np.testing.assert_array_equal(got[n], arrays[n])


def test_amp_o2_keeps_batch_norm_float32():
    """Under O2 the convolutions run in bf16 and BatchNorm in float32
    (its output, affine parameters and statistics); the O2 logits' distance
    from float32 is within the reference O2's rounding floor."""
    jm = _jax_model("NHWC")
    arrays = _arrays(jm)
    pm = _port_model(arrays, "NHWC")
    seen = {}
    for name, mod in pm.named_modules():
        if isinstance(mod, (Conv2D, BatchNorm2D)):
            mod.register_forward_hook(
                lambda m, i, o, name=name: seen.__setitem__(name, o.dtype))
    x = _images("NHWC", seed=9)
    f32 = pm(torch.from_numpy(x)).detach().numpy()
    with auto_cast(level="O2"):
        o2 = pm(torch.from_numpy(x)).float().detach().numpy()
    assert seen["conv1"] == torch.bfloat16
    assert seen["bn1"] == torch.float32
    assert seen["layer4.1.bn2"] == torch.float32
    for n, b in pm.named_buffers():
        assert b.dtype == torch.float32, n
    for n, p in pm.named_parameters():
        assert p.dtype == torch.float32, n
    with j_auto_cast(level="O2"):
        j_o2 = np.asarray(jm(paddle.to_tensor(x)).numpy()).astype(np.float32)
    j_f32 = np.asarray(jm(paddle.to_tensor(x)).numpy())
    port, ref = np.abs(o2 - f32).max(), np.abs(j_o2 - j_f32).max()
    assert 0 < ref
    assert port <= O2_FACTOR * ref, (port, ref)


def test_nhwc_runs_channels_last_without_copies():
    """An NHWC conv's output is a contiguous NHWC tensor, whose NCHW view
    is channels-last: no transposing copy between layers."""
    conv = Conv2D(3, 8, 3, padding=1, data_format="NHWC", device="cpu")
    conv.reset_parameters(torch.Generator().manual_seed(0))
    y = conv(torch.randn(2, 9, 9, 3))
    assert y.shape == (2, 9, 9, 8) and y.is_contiguous()
    assert y.permute(0, 3, 1, 2).is_contiguous(
        memory_format=torch.channels_last)


def test_resnet50_shapes_and_parameter_count():
    """resnet50's parameter count equals the reference's published one
    (25,557,032 with 1000 classes), built on the meta device."""
    m = resnet50(num_classes=1000, data_format="NHWC", device="meta")
    assert m.num_params() == 25_557_032
    assert len([b for b in m.buffers()]) == 2 * 53
