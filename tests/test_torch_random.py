"""The random ops of the PyTorch port (``ops_random``, ``mx.random``'s
samplers, ``mx.nd.random``) against the JAX package, on the CPU.

Threefry (the JAX package) and torch's generators never draw the same
numbers, so the ops are held to the JAX package in distribution, from
fixed seeds, at n = 10^5 draws each:

- each package's sample mean and variance within 5 standard errors of
  the distribution's;
- the port's draws against the distribution: ``scipy.stats.kstest``
  for a continuous one, a chi-square goodness-of-fit test over the
  values for a discrete one, p above 1e-3;
- the port's draws against the JAX package's: a two-sample
  Kolmogorov-Smirnov test, p above 1e-3.

Then the generator's rules: every draw takes the device's generator,
``mx.random.seed`` repeats the draws, and ``shuffle`` permutes.
"""
import numpy as onp
import pytest
import scipy.stats as st

import mxnet_tpu as jmx

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import nd
from mxnet_tpu_torch import random as mxrandom

CPU = mx.cpu()
N = 100_000
SEED = 20


def _host(x):
    return onp.asarray(x.asnumpy(), dtype="float64").reshape(-1)


# name -> (port draw, JAX draw, scipy distribution, discrete)
_DISTS = {
    "uniform": (lambda: mx.random.uniform(-1, 3, shape=(N,), ctx=CPU),
                lambda: jmx.random.uniform(-1, 3, shape=(N,)),
                st.uniform(loc=-1, scale=4), False),
    "normal": (lambda: mx.random.normal(0.5, 2.0, shape=(N,), ctx=CPU),
               lambda: jmx.random.normal(0.5, 2.0, shape=(N,)),
               st.norm(loc=0.5, scale=2.0), False),
    "randn": (lambda: mx.random.randn(N, ctx=CPU),
              lambda: jmx.random.randn(N), st.norm(), False),
    "randint": (lambda: mx.random.randint(-3, 5, shape=(N,), ctx=CPU),
                lambda: jmx.random.randint(-3, 5, shape=(N,)),
                st.randint(-3, 5), True),
    "exponential": (lambda: mx.random.exponential(0.5, shape=(N,), ctx=CPU),
                    lambda: jmx.random.exponential(0.5, shape=(N,)),
                    st.expon(scale=0.5), False),
    "poisson": (lambda: mx.random.poisson(3.5, shape=(N,), ctx=CPU),
                lambda: jmx.random.poisson(3.5, shape=(N,)),
                st.poisson(3.5), True),
    "gamma": (lambda: mx.random.gamma(2.5, 1.5, shape=(N,), ctx=CPU),
              lambda: jmx.random.gamma(2.5, 1.5, shape=(N,)),
              st.gamma(2.5, scale=1.5), False),
    # alpha < 1 takes the boost Gamma(alpha + 1) * U^(1 / alpha)
    "gamma_small_alpha": (
        lambda: mx.random.gamma(0.5, 2.0, shape=(N,), ctx=CPU),
        lambda: jmx.random.gamma(0.5, 2.0, shape=(N,)),
        st.gamma(0.5, scale=2.0), False),
    "negative_binomial": (
        lambda: mx.random.negative_binomial(3, 0.4, shape=(N,), ctx=CPU),
        lambda: jmx.random.negative_binomial(3, 0.4, shape=(N,)),
        st.nbinom(3, 0.4), True),
    # mean mu, dispersion alpha: NB(k = 1 / alpha, p = k / (k + mu))
    "generalized_negative_binomial": (
        lambda: mx.random.generalized_negative_binomial(2.0, 0.5,
                                                        shape=(N,), ctx=CPU),
        lambda: jmx.random.generalized_negative_binomial(2.0, 0.5,
                                                         shape=(N,)),
        st.nbinom(2.0, 0.5), True),
    "gumbel": (lambda: nd.random_gumbel(1.0, 2.0, shape=(N,), ctx=CPU),
               lambda: jmx.nd.random_gumbel(1.0, 2.0, shape=(N,)),
               st.gumbel_r(loc=1.0, scale=2.0), False),
    "multinomial": (
        lambda: mx.random.multinomial(nd.array([0.1, 0.2, 0.3, 0.4],
                                               ctx=CPU), shape=(N,)),
        lambda: jmx.random.multinomial(jmx.nd.array([0.1, 0.2, 0.3, 0.4]),
                                       shape=(N,)),
        st.rv_discrete(values=([0, 1, 2, 3], [0.1, 0.2, 0.3, 0.4])), True),
}


def _within_5_se(x, mean, var, what):
    n = x.size
    m = x.mean()
    v = x.var()
    se_mean = onp.sqrt(var / n)
    se_var = onp.sqrt(max(((x - m) ** 4).mean() - v * v, 1e-30) / n)
    assert abs(m - mean) < 5 * se_mean, (what, "mean", m, mean, se_mean)
    assert abs(v - var) < 5 * se_var, (what, "variance", v, var, se_var)


def _fit_p(x, dist, discrete):
    if not discrete:
        return st.kstest(x, dist.cdf).pvalue
    # chi-square over the values, the sparse tail pooled into the last
    # bin so each bin expects at least 5 draws
    values, counts = onp.unique(x.astype("int64"), return_counts=True)
    lo, hi = int(dist.ppf(1e-6)), int(dist.ppf(1 - 1e-6))
    edges = onp.arange(lo, hi + 1)
    expected = dist.pmf(edges) * x.size
    observed = onp.array([counts[values == e].sum() for e in edges],
                         dtype="float64")
    keep = expected >= 5
    exp_k, obs_k = expected[keep], observed[keep]
    if x.size - exp_k.sum() >= 5:
        exp_k = onp.append(exp_k, x.size - exp_k.sum())
        obs_k = onp.append(obs_k, x.size - obs_k.sum())
    else:  # a bounded support: nothing left over to pool
        exp_k = exp_k * (obs_k.sum() / exp_k.sum())
    return st.chisquare(obs_k, exp_k).pvalue


@pytest.mark.parametrize("name", sorted(_DISTS))
def test_draws_match_the_distribution_and_the_jax_package(name):
    port, jax_draw, dist, discrete = _DISTS[name]
    mx.random.seed(SEED)
    jmx.random.seed(SEED)
    x, j = _host(port()), _host(jax_draw())
    assert x.size == j.size == N
    mean, var = dist.mean(), dist.var()
    _within_5_se(x, mean, var, f"{name} (port)")
    _within_5_se(j, mean, var, f"{name} (JAX package)")
    assert _fit_p(x, dist, discrete) > 1e-3
    assert st.ks_2samp(x, j).pvalue > 1e-3


@pytest.mark.parametrize("op,kwargs,dists", [
    ("sample_uniform", {"low": [0.0, 2.0], "high": [1.0, 5.0]},
     [st.uniform(0, 1), st.uniform(2, 3)]),
    ("sample_normal", {"mu": [0.0, 3.0], "sigma": [1.0, 0.5]},
     [st.norm(0, 1), st.norm(3, 0.5)]),
])
def test_per_row_samplers_match_the_jax_package(op, kwargs, dists):
    mx.random.seed(SEED)
    jmx.random.seed(SEED)
    a, b = kwargs.values()
    got = getattr(nd, op)(nd.array(a, ctx=CPU), nd.array(b, ctx=CPU),
                          shape=(N // 2,)).asnumpy()
    want = getattr(jmx.nd, op)(jmx.nd.array(a), jmx.nd.array(b),
                               shape=(N // 2,)).asnumpy()
    assert got.shape == want.shape == (2, N // 2)
    for row, dist in enumerate(dists):
        x = got[row].astype("float64")
        _within_5_se(x, dist.mean(), dist.var(), f"{op} row {row}")
        assert st.kstest(x, dist.cdf).pvalue > 1e-3
        assert st.ks_2samp(x, want[row]).pvalue > 1e-3


def test_multinomial_batches_and_log_probabilities_match_jax():
    p = onp.asarray([[0.5, 0.5, 0.0], [0.1, 0.0, 0.9]], "float32")
    mx.random.seed(SEED)
    out, logp = mx.random.multinomial(nd.array(p, ctx=CPU), shape=(3, 4),
                                      get_prob=True)
    jout, jlogp = jmx.random.multinomial(jmx.nd.array(p), shape=(3, 4),
                                         get_prob=True)
    assert out.shape == jout.shape == (2, 3, 4)
    assert str(out.dtype) == str(jout.dtype) == "int32"
    o = out.asnumpy()
    assert (o[0] != 2).all() and (o[1] != 1).all()  # zero probability
    want = onp.log(p[onp.arange(2)[:, None, None], o])
    onp.testing.assert_allclose(logp.asnumpy(), want, rtol=1e-6)
    assert str(logp.dtype) == str(jlogp.dtype)


def test_dtypes_and_shapes_match_jax():
    pairs = [
        (mx.random.uniform(shape=(2, 3), ctx=CPU),
         jmx.random.uniform(shape=(2, 3))),
        (mx.random.randint(0, 4, shape=(5,), ctx=CPU),
         jmx.random.randint(0, 4, shape=(5,))),
        (mx.random.poisson(2.0, shape=(3,), ctx=CPU),
         jmx.random.poisson(2.0, shape=(3,))),
        (mx.random.normal(shape=(4,), dtype="float16", ctx=CPU),
         jmx.random.normal(shape=(4,), dtype="float16")),
        (nd.random.gamma(2.0, shape=(2, 2), ctx=CPU),
         jmx.nd.random.gamma(2.0, shape=(2, 2))),
    ]
    for got, want in pairs:
        assert got.shape == want.shape
        assert str(got.dtype) == str(want.dtype)


def test_nd_random_namespace_matches_jax():
    names = ("uniform", "normal", "randn", "randint", "exponential",
             "poisson", "gamma", "negative_binomial",
             "generalized_negative_binomial", "multinomial", "shuffle")
    for name in names:
        assert callable(getattr(nd.random, name))
        assert callable(getattr(jmx.nd.random, name))


def test_seed_repeats_the_draws_and_each_op_draws_from_the_generator():
    mx.random.seed(7)
    a = mx.random.uniform(shape=(6,), ctx=CPU).asnumpy()
    g = nd.random.gamma(0.7, shape=(6,), ctx=CPU).asnumpy()
    before = mxrandom.draws()
    c = mx.random.uniform(shape=(6,), ctx=CPU).asnumpy()
    assert mxrandom.draws() == before + 1
    assert not onp.array_equal(a, c)
    mx.random.seed(7)
    onp.testing.assert_array_equal(
        mx.random.uniform(shape=(6,), ctx=CPU).asnumpy(), a)
    onp.testing.assert_array_equal(
        nd.random.gamma(0.7, shape=(6,), ctx=CPU).asnumpy(), g)


def test_seed_reseeds_the_generator_in_place():
    """A graph that registered the generator keeps the same object: the
    seed must reach it."""
    gen = mxrandom.device_generator(CPU.torch_device)
    mx.random.seed(3)
    assert mxrandom.device_generator(CPU.torch_device) is gen
    x = mx.random.normal(shape=(4,), ctx=CPU).asnumpy()
    mx.random.seed(3)
    onp.testing.assert_array_equal(
        mx.random.normal(shape=(4,), ctx=CPU).asnumpy(), x)


def test_out_argument_writes_in_place():
    out = nd.zeros((3, 2), ctx=CPU)
    tensor = out.data
    r = mx.random.uniform(2.0, 3.0, shape=(3, 2), ctx=CPU, out=out)
    assert r is out and out.data is tensor
    v = out.asnumpy()
    assert ((v >= 2.0) & (v < 3.0)).all()


def test_shuffle_permutes_rows_uniformly():
    mx.random.seed(SEED)
    base = onp.arange(10, dtype="float32").reshape(5, 2)
    firsts = []
    for _ in range(400):
        s = nd.random.shuffle(nd.array(base, ctx=CPU)).asnumpy()
        assert sorted(map(tuple, s)) == sorted(map(tuple, base))
        firsts.append(int(s[0, 0]) // 2)
    counts = onp.bincount(firsts, minlength=5)
    assert st.chisquare(counts).pvalue > 1e-3
    j = jmx.nd.random.shuffle(jmx.nd.array(base)).asnumpy()
    assert sorted(map(tuple, j)) == sorted(map(tuple, base))
