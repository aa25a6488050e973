"""The port's threefry PRNG and sampler (nos_tpu_torch/prng.py) against
`jax.random`, and temperature sampling in the port's `generate` and
`DecodeServer` against the JAX package's, on the CPU.

Keys, bits and uniforms must be bit-identical (integers and float bit
patterns compared exactly). Gumbel noise goes through `log`, which is not
bit-identical across XLA's CPU code and torch: the port's is held to the
float64 gumbel of the (bit-identical) uniforms, |dg| <= 1e-6 * max(1, |g|)
(the absolute error of -log(-log u) is ~1 ulp of log u, whatever g's size).
Sampled tokens can differ only on a near-exact tie of gumbel + logits; on
the seeds named here they must be identical."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nos_tpu.models import decode as jd
from nos_tpu.models.gpt import init_gpt as jax_init_gpt
from nos_tpu.runtime.decode_server import DecodeServer as JaxServer
from nos_tpu_torch import DecodeServer, prng
from nos_tpu_torch.models import decode as td
from nos_tpu_torch.models.gpt import GPTConfig as TGPTConfig
from nos_tpu_torch.models.params import from_numpy_params

from conftest import serving_test_config, serving_test_params
from test_decode import CFG as DECODE_CFG

SEEDS = [0, 7, 2**31 - 1]
# Serials and steps past 2^16 (and one past 2^31) exercise every word of
# the counters.
SERIALS = [1, 2, 3, 70000, 2**31 + 5]
STEPS = [0, 1, 63, 65537]
JAX_OFF = dict(surgical_recovery=False)


def _words(x):
    return np.asarray(x).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_bit_identical(seed):
    jkey, tkey = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    np.testing.assert_array_equal(tkey.numpy(), _words(jkey))
    np.testing.assert_array_equal(prng.split(tkey, 5).numpy(), _words(jax.random.split(jkey, 5)))
    np.testing.assert_array_equal(prng.split(prng.split(tkey)[1], 3).numpy(),
                                  _words(jax.random.split(jax.random.split(jkey)[1], 3)))
    for serial in SERIALS:
        for step in STEPS:
            want = jax.random.fold_in(jax.random.fold_in(jkey, serial), step)
            got = prng.fold_in(prng.fold_in(tkey, serial), step)
            np.testing.assert_array_equal(got.numpy(), _words(want), err_msg=f"{serial} {step}")


@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in_over_lanes_is_the_vmap(seed):
    """fold_in with a [N] data vector (and [N, 2] keys) equals JAX's vmap
    of the scalar fold_in: the engine's per-lane keys."""
    grid = np.array([(s, t) for s in SERIALS for t in STEPS], np.int64)
    base = jax.random.PRNGKey(seed)
    want = jax.vmap(lambda s, t: jax.random.fold_in(jax.random.fold_in(base, s), t))(
        jnp.asarray(grid[:, 0], jnp.uint32), jnp.asarray(grid[:, 1], jnp.uint32))
    got = prng.fold_in(prng.fold_in(prng.PRNGKey(seed), torch.from_numpy(grid[:, 0])),
                       torch.from_numpy(grid[:, 1]))
    np.testing.assert_array_equal(got.numpy(), _words(want))


@pytest.mark.parametrize("seed", SEEDS)
def test_bits_and_uniform_bit_identical(seed):
    jkey, tkey = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    bits = prng.random_bits(tkey, (3, 32000))
    np.testing.assert_array_equal(bits.numpy(),
                                  _words(jax.random.bits(jkey, (3, 32000), jnp.uint32)))
    u = prng.uniform(tkey, (3, 32000)).numpy()
    np.testing.assert_array_equal(u.view(np.int32),
                                  np.asarray(jax.random.uniform(jkey, (3, 32000))).view(np.int32))
    tiny = np.finfo(np.float32).tiny
    u = prng.uniform(tkey, (3, 32000), tiny, 1.0).numpy()
    want = np.asarray(jax.random.uniform(jkey, (3, 32000), minval=tiny, maxval=1.0))
    np.testing.assert_array_equal(u.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("seed", SEEDS)
def test_gumbel_within_float32_rounding(seed):
    """The port's gumbel against -log(-log(u)) in float64 over the uniforms
    JAX draws (bit for bit the port's), at 1e-6 relative. JAX's own gumbel
    goes through XLA's CPU `log`; its gap to the same float64 values is
    reported on failure beside the port's, with the worst element."""
    tiny = np.finfo(np.float32).tiny
    u = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), (3, 32000), minval=tiny,
                                      maxval=1.0))
    np.testing.assert_array_equal(
        prng.uniform(prng.PRNGKey(seed), (3, 32000), tiny, 1.0).numpy().view(np.int32),
        u.view(np.int32))
    exact = -np.log(-np.log(u.astype(np.float64)))
    got = prng.gumbel(prng.PRNGKey(seed), (3, 32000)).numpy()
    jax_g = np.asarray(jax.random.gumbel(jax.random.PRNGKey(seed), (3, 32000)))
    scale = np.maximum(1.0, np.abs(exact))
    gap, jax_gap = np.abs(got - exact) / scale, np.abs(jax_g - exact) / scale
    i = int(np.argmax(gap))
    assert gap.max() <= 1e-6, (
        f"worst element {i}: uniform bits {u.view(np.uint32).flat[i]:#010x}, port "
        f"{got.flat[i]!r}, JAX {jax_g.flat[i]!r}, float64 {exact.flat[i]!r}; "
        f"port gap {gap.max():.3g}, JAX gap {jax_gap.max():.3g}")


@pytest.mark.parametrize("seed", SEEDS)
def test_categorical_tokens_identical(seed):
    logits = np.random.RandomState(seed % 1000).randn(6, 97).astype(np.float32) * 2
    jkey, tkey = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    # One key over the whole [6, 97] batch (generate's call) ...
    np.testing.assert_array_equal(
        prng.categorical(tkey, torch.from_numpy(logits)).numpy(),
        np.asarray(jax.random.categorical(jkey, logits)))
    # ... and one key per row (the engine's vmap).
    want = jax.vmap(jax.random.categorical)(jax.random.split(jkey, 6), logits)
    got = prng.categorical(prng.split(tkey, 6), torch.from_numpy(logits))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError):
        prng.categorical(prng.split(tkey, 5), torch.from_numpy(logits))


def _bridged(jcfg, jparams):
    tcfg = TGPTConfig(**dataclasses.asdict(jcfg))
    return tcfg, from_numpy_params(jax.tree_util.tree_map(np.asarray, jparams), tcfg,
                                   device="cpu")


@pytest.mark.parametrize("which", ["serving", "decode"])
def test_sampled_generate_matches_jax(which):
    """generate(temperature=0.8, rng=PRNGKey(9)) (tests/test_decode.py:77-84)."""
    if which == "serving":
        jcfg, jparams = serving_test_config(), serving_test_params()
    else:
        jcfg, jparams = DECODE_CFG, jax_init_gpt(jax.random.PRNGKey(0), DECODE_CFG)
    tcfg, tparams = _bridged(jcfg, jparams)
    prompt = np.random.RandomState(3).randint(0, jcfg.vocab, size=(2, 3)).astype(np.int32)
    want = jax.jit(lambda p, x: jd.generate(p, x, jcfg, steps=8, temperature=0.8,
                                            rng=jax.random.PRNGKey(9)))(jparams, jnp.asarray(prompt))
    got = td.generate(tparams, torch.from_numpy(prompt), tcfg, steps=8, temperature=0.8,
                      rng=prng.PRNGKey(9))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # rng=None is PRNGKey(0) in both.
    want0 = jd.generate(jparams, jnp.asarray(prompt), jcfg, steps=4, temperature=0.8)
    got0 = td.generate(tparams, torch.from_numpy(prompt), tcfg, steps=4, temperature=0.8)
    np.testing.assert_array_equal(got0.numpy(), np.asarray(want0))


@pytest.fixture(scope="module")
def serving_model():
    jcfg, jparams = serving_test_config(), serving_test_params()
    return (jcfg, jparams) + _bridged(jcfg, jparams)


def _serve(server, traffic):
    futs = [server.submit(p, n) for p, n in traffic]
    server.start()
    try:
        return [f.result(timeout=300) for f in futs]
    finally:
        server.stop()


@pytest.mark.parametrize("k", [1, 4])
def test_sampled_engine_matches_jax(serving_model, k):
    """DecodeServer(temperature=0.8, seed=7): the same tokens as the JAX
    engine, at one and at four steps per macro dispatch, both engines
    bursting with their default burst_windows=4."""
    jcfg, jparams, tcfg, tparams = serving_model
    rng = np.random.RandomState(12)
    traffic = [(rng.randint(1, 97, size=n).tolist(), m) for n, m in ((4, 9), (11, 6), (7, 12))]
    kw = dict(n_slots=2, max_len=64, temperature=0.8, seed=7, steps_per_dispatch=k)
    jout = _serve(JaxServer(jparams, jcfg, **JAX_OFF, **kw), traffic)
    tout = _serve(DecodeServer(tparams, tcfg, device="cpu", **kw), traffic)
    assert tout == jout
    greedy = _serve(DecodeServer(tparams, tcfg, device="cpu", n_slots=2, max_len=64),
                    traffic)
    assert tout != greedy  # the sampler ran


def test_sampled_stream_independent_of_batchmates(serving_model):
    """tests/test_decode_server.py:225-250 on the port: a request's sampled
    tokens (serial 1, seed 7) are the same alone or beside a batchmate."""
    _, _, tcfg, tparams = serving_model
    kw = dict(n_slots=2, max_len=64, temperature=0.8, seed=7, device="cpu")
    prompt = [4, 9, 2]
    alone = _serve(DecodeServer(tparams, tcfg, **kw), [(prompt, 6)])[0]
    together = _serve(DecodeServer(tparams, tcfg, **kw), [(prompt, 6), ([30, 31, 32, 33], 8)])
    assert together[0] == alone and len(alone) == 6
