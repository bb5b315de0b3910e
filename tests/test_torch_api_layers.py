"""``nn.Layer`` and the layers of the Paddle API against the JAX package's:
registration and ``state_dict`` names and order for the same Layer code,
``set_state_dict`` from the JAX package's state dict, ``train``/``eval``
and the hooks, ``paddle.save`` in one package and ``paddle.load`` in the
other, the initializers, each layer's forward and backward, AMP O1/O2 casts
of a ``Linear`` → ``LayerNorm`` → ``Linear`` chain op by op, and the five
layers the port's models are built from still taking torch tensors."""
import numpy as np
import pytest
import torch

X = np.random.RandomState(0).uniform(-1, 1, (2, 3, 8)).astype(np.float32)


def _both():
    import paddle_tpu
    import paddle_tpu_torch
    paddle_tpu_torch.set_device("cpu")
    return paddle_tpu, paddle_tpu_torch


def _net(P):
    nn = P.nn

    class Net(nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc = nn.Linear(8, 16)
            self.norm = nn.LayerNorm(16)
            self.blocks = nn.LayerList([nn.Linear(16, 16) for _ in range(2)])
            self.seq = nn.Sequential(nn.GELU(), nn.Linear(16, 4),
                                     nn.Dropout(0.0))
            self.register_buffer("steps", P.to_tensor(np.zeros([1],
                                                                np.int64)))
            self.register_buffer("scratch", P.to_tensor(np.zeros([2],
                                                                 np.float32)),
                                 persistable=False)

        def forward(self, x):
            h = self.norm(self.fc(x))
            for b in self.blocks:
                h = h + b(h)
            return self.seq(h)
    return Net()


def _arrays(sd):
    return {k: np.asarray(v.numpy()) for k, v in sd.items()}


def test_state_dict_names_order_and_cross_load():
    jp, tp = _both()
    jn, tn = _net(jp), _net(tp)
    assert list(tn.state_dict()) == list(jn.state_dict())
    assert [n for n, _ in tn.named_parameters()] == \
        [n for n, _ in jn.named_parameters()]
    assert [n for n, _ in tn.named_sublayers()] == \
        [n for n, _ in jn.named_sublayers()]
    missing, unexpected = tn.set_state_dict(_arrays(jn.state_dict()))
    assert not missing and not unexpected
    for (n, p), (_, q) in zip(tn.state_dict().items(),
                              jn.state_dict().items()):
        np.testing.assert_array_equal(p.numpy(), q.numpy(), err_msg=n)
    # forward and backward of the whole net against the reference
    outs = []
    for P, net in ((tp, tn), (jp, jn)):
        x = P.to_tensor(X, stop_gradient=False)
        y = net(x)
        (y * y).sum().backward()
        outs.append((y.numpy(), x.grad.numpy(),
                     {n: p.grad.numpy() for n, p in net.named_parameters()}))
    (py, px, pg), (ry, rx, rg) = outs
    np.testing.assert_allclose(py, ry, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(px, rx, rtol=1e-5, atol=1e-5)
    for n in rg:
        np.testing.assert_allclose(pg[n], rg[n], rtol=1e-5, atol=1e-5,
                                   err_msg=n)


def test_registration_train_eval_and_hooks():
    _, tp = _both()
    net = _net(tp)
    assert isinstance(net.fc.weight, tp.Parameter)
    assert net.fc.weight.shape == [8, 16] and not net.fc.weight.stop_gradient
    assert isinstance(net.steps, tp.Tensor) and "scratch" not in \
        net.state_dict()
    assert len(net.parameters()) == 10
    assert all(isinstance(p, tp.Parameter) for p in net.parameters())
    net.eval()
    assert not net.training and not net.seq[2].training
    net.train()
    assert net.seq[2].training
    calls = []
    pre = net.fc.register_forward_pre_hook(
        lambda layer, inputs: calls.append("pre"))
    post = net.fc.register_forward_post_hook(
        lambda layer, inputs, out: out * 0)
    y = net.fc(tp.to_tensor(X))
    assert calls == ["pre"] and float(y.abs().sum()) == 0.0
    pre.remove()
    post.remove()
    assert float(net.fc(tp.to_tensor(X)).abs().sum()) > 0
    extra = tp.create_parameter([3], "float32")
    net.add_parameter("extra", extra)
    assert "extra" in dict(net.named_parameters())
    net.clear_gradients()
    net.astype("bfloat16")
    assert str(net.fc.weight.dtype) == "bfloat16"
    assert str(net.steps.dtype) == "int64"


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_save_in_one_package_load_in_the_other(tmp_path, writer):
    jp, tp = _both()
    src, dst = (tp, jp) if writer == "port" else (jp, tp)
    a, b = _net(src), _net(dst)
    path = str(tmp_path / "net.pdparams")
    src.save(a.state_dict(), path)
    b.set_state_dict(dst.load(path))
    x = X[0]
    np.testing.assert_allclose(b(dst.to_tensor(x)).numpy(),
                               a(src.to_tensor(x)).numpy(), rtol=1e-5,
                               atol=1e-6)


def test_initializers():
    jp, tp = _both()
    I, JI = tp.nn.initializer, jp.nn.initializer
    value = np.arange(6, dtype=np.float32).reshape(2, 3)
    for make in (lambda M: M.Constant(0.5), lambda M: M.Assign(value),
                 lambda M: M.Dirac(), lambda M: M.Bilinear()):
        shape = [2, 3] if make(I).__class__.__name__ in ("Constant",
                                                         "Assign") \
            else [2, 2, 3, 3]
        got = make(I)(shape, torch.float32).numpy()
        want = np.asarray(make(JI)(shape, np.float32))
        np.testing.assert_array_equal(got, want)
    tp.seed(0)
    n = 256
    fan = {"in": 256, "out": 256}
    xn = I.XavierNormal()([n, n], torch.float32).numpy()
    assert abs(xn.std() - np.sqrt(2.0 / (fan["in"] + fan["out"]))) < 0.003
    xu = I.XavierUniform()([n, n], torch.float32).numpy()
    limit = np.sqrt(6.0 / (2 * n))
    assert xu.max() <= limit and xu.min() >= -limit
    assert abs(xu.std() - limit / np.sqrt(3)) < 0.003
    nrm = I.Normal(1.0, 2.0)([n, n], torch.float32).numpy()
    assert abs(nrm.mean() - 1.0) < 5 * 2.0 / n and abs(nrm.std() - 2) < 0.03
    tn = I.TruncatedNormal(0.0, 1.0)([n, n], torch.float32).numpy()
    assert np.abs(tn).max() <= 2.0
    un = I.Uniform(-0.1, 0.1)([n, n], torch.float32).numpy()
    assert un.min() >= -0.1 and un.max() <= 0.1
    lin = tp.nn.Linear(n, n)      # the reference's default: Xavier normal
    assert abs(lin.weight.numpy().std() - np.sqrt(1.0 / n)) < 0.003
    assert not lin.bias.numpy().any()
    emb = tp.nn.Embedding(10, 4, padding_idx=2)
    assert not emb.weight.numpy()[2].any()
    attr = tp.ParamAttr(initializer=I.Constant(3.0), learning_rate=0.5)
    p = tp.nn.Linear(2, 2, weight_attr=attr).weight
    assert (p.numpy() == 3.0).all() and p.optimize_attr["learning_rate"] \
        == 0.5


LAYERS = [
    ("Linear", (8, 5), {}), ("LayerNorm", (8,), {}),
    ("Embedding", (10, 8), {"padding_idx": 0}), ("Identity", (), {}),
    ("Flatten", (), {}), ("Dropout", (0.0,), {}),
    ("ReLU", (), {}), ("GELU", (), {}), ("GELU", (True,), {}),
    ("Sigmoid", (), {}), ("Tanh", (), {}), ("Silu", (), {}),
    ("LeakyReLU", (0.2,), {}), ("ELU", (), {}), ("Softmax", (), {}),
    ("LogSoftmax", (), {}), ("Hardswish", (), {}), ("Mish", (), {}),
    ("Softplus", (), {}), ("PReLU", (), {}), ("SELU", (), {}),
    ("Hardtanh", (), {}), ("CELU", (), {}), ("ReLU6", (), {}),
    ("Swish", (), {}), ("Softsign", (), {}), ("Tanhshrink", (), {}),
    ("LogSigmoid", (), {}), ("Hardsigmoid", (), {}), ("GLU", (), {}),
    ("Hardshrink", (), {}), ("Softshrink", (), {}),
    ("ThresholdedReLU", (), {}), ("Maxout", (2,), {"axis": -1}),
    ("Softmax2D", (), {}),
]


@pytest.mark.parametrize("name,args,kwargs", LAYERS,
                         ids=[f"{n}{i}" for i, (n, _, _) in
                              enumerate(LAYERS)])
def test_layer_forward_and_backward(name, args, kwargs):
    jp, tp = _both()
    jl = getattr(jp.nn, name)(*args, **kwargs)
    tl = getattr(tp.nn, name)(*args, **kwargs)
    tl.set_state_dict(_arrays(jl.state_dict()))
    ids = name == "Embedding"
    x = np.random.RandomState(1).randint(0, 10, (2, 3)) if ids else X
    res = []
    for P, layer in ((tp, tl), (jp, jl)):
        xt = P.to_tensor(x, stop_gradient=ids)
        y = layer(xt)
        w = P.to_tensor(np.random.RandomState(2).uniform(
            -1, 1, y.shape).astype(np.float32))
        (y * w).sum().backward()
        res.append((y.numpy(), None if ids else xt.grad.numpy(),
                    {n: p.grad.numpy() for n, p in layer.named_parameters()}))
    (py, px, pg), (ry, rx, rg) = res
    np.testing.assert_allclose(py, ry, rtol=1e-5, atol=1e-6)
    if px is not None:
        np.testing.assert_allclose(px, rx, rtol=1e-5, atol=1e-6)
    assert pg.keys() == rg.keys()
    for n in rg:
        np.testing.assert_allclose(pg[n], rg[n], rtol=1e-5, atol=1e-5)


def test_cross_entropy_loss_layer_and_reductions():
    jp, tp = _both()
    logits = np.random.RandomState(3).randn(6, 5).astype(np.float32)
    labels = np.array([0, 4, -100, 2, 1, 3], np.int64)
    for red in ("mean", "sum", "none"):
        got = tp.nn.CrossEntropyLoss(reduction=red)(
            tp.to_tensor(logits), tp.to_tensor(labels)).numpy()
        want = jp.nn.CrossEntropyLoss(reduction=red)(
            jp.to_tensor(logits), jp.to_tensor(labels)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("level", ["O1", "O2"])
def test_amp_casts_op_by_op(level):
    """The dtype out of each op of Linear → LayerNorm → Linear under
    ``auto_cast`` equals the reference's (layer_norm black-listed: float32
    out; linear white-listed; O2 casts the rest)."""
    jp, tp = _both()
    got = {}
    for P in (tp, jp):
        nn = P.nn
        chain = [nn.Linear(8, 8), nn.LayerNorm(8), nn.Linear(8, 4)]
        x = P.to_tensor(X)
        dtypes = []
        with P.amp.auto_cast(level=level, dtype="bfloat16"):
            h = x
            for layer in chain:
                h = layer(h)
                dtypes.append(str(h.dtype))
            dtypes.append(str((h + 1.0).dtype))
            dtypes.append(str(P.nn.functional.softmax(h).dtype))
        got[P.__name__] = dtypes
    assert got["paddle_tpu_torch"] == got["paddle_tpu"]


def test_converted_layers_take_torch_tensors():
    """``Dropout``, ``Conv2D``, ``BatchNorm2D``, ``MaxPool2D`` and
    ``AdaptiveAvgPool2D`` are Layers now and still give torch tensors for
    torch tensors (the port's models build on them)."""
    _, tp = _both()
    from paddle_tpu_torch.nn import (AdaptiveAvgPool2D, BatchNorm2D, Conv2D,
                                     Dropout, MaxPool2D)
    conv = Conv2D(3, 4, 3, padding=1, device="cpu")
    conv.reset_parameters(torch.Generator().manual_seed(0))
    bn = BatchNorm2D(4, device="cpu")
    net = torch.nn.Sequential(conv, bn, MaxPool2D(2), AdaptiveAvgPool2D(1),
                              Dropout(0.5))
    x = torch.randn(2, 3, 8, 8)
    y = net(x)
    assert type(y) is torch.Tensor and y.shape == (2, 4, 1, 1)
    assert set(net.state_dict()) == {"0.weight", "0.bias", "1.weight",
                                     "1.bias", "1._mean", "1._variance"}
    assert all(type(v) is torch.Tensor or isinstance(v, torch.nn.Parameter)
               for v in net.state_dict().values())
    for layer in (conv, bn):
        assert isinstance(layer, tp.nn.Layer)
        assert isinstance(layer.weight, tp.Parameter)
    yp = net(tp.to_tensor(x.numpy()))
    assert isinstance(yp, tp.Tensor)


def test_device_rule(monkeypatch):
    """Tensors and parameters go to the card unless ``set_device("cpu")``
    asked for the CPU; without a GPU and without that request making one
    raises (importing the package did not). A TPU, XPU or NPU place is a
    name only: using one raises, naming what the port runs on."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.framework import device
    monkeypatch.setattr(device, "_place", None)
    if torch.cuda.is_available():
        assert paddle.to_tensor([1.0]).place == paddle.CUDAPlace(
            torch.cuda.current_device())
    else:
        for make in (lambda: paddle.to_tensor([1.0]),
                     lambda: paddle.zeros([2]), lambda: paddle.randn([2]),
                     lambda: paddle.nn.Linear(2, 2)):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                make()
    for name in ("tpu", "xpu:0", "npu"):
        with pytest.raises(RuntimeError, match="NVIDIA GPUs"):
            paddle.set_device(name)
    with pytest.raises(RuntimeError, match="NVIDIA GPUs"):
        paddle.to_tensor([1.0], place=paddle.TPUPlace(0))
    assert paddle.set_device("cpu") == paddle.CPUPlace()
    assert paddle.get_device() == "cpu"
    t = paddle.to_tensor([1.0])
    assert t.place == paddle.CPUPlace() and t.place.is_cpu_place()
