"""The Paddle API's random ops. torch's generator cannot reproduce JAX's
stream, so these hold, against the JAX package's ops where they apply: the
shape, dtype and place of each result; the same ``paddle.seed`` giving the
same draw; ``get_rng_state``/``set_rng_state`` round-tripping; and the
moments of 10^5 samples within 5 sigma of the distribution's."""
import numpy as np
import pytest

N = 100_000


@pytest.fixture
def paddle():
    import paddle_tpu_torch
    paddle_tpu_torch.set_device("cpu")
    return paddle_tpu_torch


def _jax():
    import paddle_tpu
    return paddle_tpu


DRAWS = {
    "rand": lambda P, n: P.rand([n]),
    "randn": lambda P, n: P.randn([n]),
    "standard_normal": lambda P, n: P.standard_normal([n]),
    "normal": lambda P, n: P.normal(1.0, 2.0, [n]),
    "gaussian": lambda P, n: P.gaussian([n], mean=-1.0, std=0.5),
    "uniform": lambda P, n: P.uniform([n], min=-2.0, max=3.0),
    "randint": lambda P, n: P.randint(0, 10, [n]),
    "randperm": lambda P, n: P.randperm(n),
    "bernoulli": lambda P, n: P.bernoulli(P.full([n], 0.3)),
    "multinomial": lambda P, n: P.multinomial(
        P.to_tensor([0.1, 0.2, 0.7]), n, replacement=True),
    "poisson": lambda P, n: P.poisson(P.full([n], 4.0)),
    "rand_like": lambda P, n: P.rand_like(P.zeros([n])),
    "randn_like": lambda P, n: P.randn_like(P.zeros([n])),
    "randint_like": lambda P, n: P.randint_like(P.zeros([n], "int64"), 0,
                                                10),
}
# mean and variance of each draw's distribution
MOMENTS = {
    "rand": (0.5, 1 / 12), "randn": (0.0, 1.0), "standard_normal": (0, 1),
    "normal": (1.0, 4.0), "gaussian": (-1.0, 0.25),
    "uniform": (0.5, 25 / 12), "randint": (4.5, 99 / 12),
    "randperm": ((N - 1) / 2, (N * N - 1) / 12), "bernoulli": (0.3, 0.21),
    "multinomial": (1.6, 0.44), "poisson": (4.0, 4.0),
    "rand_like": (0.5, 1 / 12), "randn_like": (0.0, 1.0),
    "randint_like": (4.5, 99 / 12),
}


@pytest.mark.parametrize("name", sorted(DRAWS))
def test_draw_matches_jax_shape_dtype_and_moments(paddle, name):
    jp = _jax()
    paddle.seed(1234)
    got = DRAWS[name](paddle, N)
    ref = DRAWS[name](jp, 8)
    assert isinstance(got, paddle.Tensor)
    assert str(got.dtype) == str(ref.dtype), (got.dtype, ref.dtype)
    assert got.shape == [N] and ref.shape == [8]
    assert got.place == paddle.CPUPlace()
    x = got.numpy().astype(np.float64)
    mean, var = MOMENTS[name]
    assert abs(x.mean() - mean) <= 5 * np.sqrt(var / N), (x.mean(), mean)
    # the sample variance's standard error, with a 4th moment of at most
    # 9 sigma^4 for these distributions
    assert abs(x.var() - var) <= 5 * np.sqrt(8 * var * var / N), \
        (x.var(), var)
    if name == "randperm":
        assert np.array_equal(np.sort(x), np.arange(N))


@pytest.mark.parametrize("name", sorted(DRAWS))
def test_same_seed_same_draw(paddle, name):
    paddle.seed(7)
    a = DRAWS[name](paddle, 64).numpy()
    paddle.seed(7)
    b = DRAWS[name](paddle, 64).numpy()
    paddle.seed(8)
    c = DRAWS[name](paddle, 64).numpy()
    assert np.array_equal(a, b)
    assert not np.array_equal(a, c) or name in ("bernoulli",
                                                "multinomial")


def test_rng_state_round_trips(paddle):
    paddle.seed(3)
    state = paddle.get_rng_state()
    a = paddle.randn([16]).numpy()
    paddle.randn([16])
    paddle.set_rng_state(state)
    assert np.array_equal(paddle.randn([16]).numpy(), a)


@pytest.mark.parametrize("name", ["uniform_", "normal_", "bernoulli_",
                                  "exponential_"])
def test_in_place_draws(paddle, name):
    """The in-place draws fill the tensor they are given, with its dtype and
    shape, from the same generator."""
    jp = _jax()
    kwargs = {"uniform_": {"min": 0.0, "max": 2.0}, "normal_": {},
              "bernoulli_": {"p": 0.25}, "exponential_": {"lam": 2.0}}[name]
    moments = {"uniform_": (1.0, 1 / 3), "normal_": (0.0, 1.0),
               "bernoulli_": (0.25, 0.1875),
               "exponential_": (0.5, 0.25)}[name]
    paddle.seed(1234)
    x = paddle.zeros([N])
    assert getattr(x, name)(**kwargs) is x
    r = jp.zeros([8])
    getattr(r, name)(**kwargs)
    assert str(x.dtype) == str(r.dtype)
    v = x.numpy().astype(np.float64)
    assert abs(v.mean() - moments[0]) <= 5 * np.sqrt(moments[1] / N)
