"""The port's collectives (nos_tpu_torch/parallel/collectives.py) against the
JAX package's (nos_tpu/parallel/collectives.py) under `shard_map` on the
virtual CPU devices.

Shard i's block is row block i of one numpy array on both sides: JAX gets
the global array sharded P("x") and its output gathered back with
out_specs P("x"); the port gets the list of blocks and returns the list.
Permutes, gathers and all-to-all are exact; sums rtol 1e-6 (the port adds
in shard order, XLA in its own). Gradients of a weighted sum of the
outputs agree as well (the JAX function's through `jax.grad`)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh, PartitionSpec as P

from nos_tpu.parallel import collectives as jcol
from nos_tpu_torch.parallel import collectives as tcol

try:
    from jax import shard_map
except ImportError:  # older jax
    from jax.experimental.shard_map import shard_map

N = 4
BLOCK = (3, 8, 4)  # each shard's block; dims 1 and 2 divide by N


def _jmesh(n=N):
    return JMesh(np.array(jax.devices()[:n]), ("x",))


def _blocks(seed, n=N, shape=BLOCK):
    return np.random.RandomState(seed).randn(n * shape[0], *shape[1:]).astype(np.float32)


def _jax(fn, x, n=N):
    """fn on each device's block under shard_map; -> each device's output."""
    out = shard_map(fn, mesh=_jmesh(n), in_specs=P("x"), out_specs=P("x"))(jnp.asarray(x))
    return np.split(np.asarray(out), n)


def _torch(fn, x, n=N):
    return [y.numpy() for y in fn(list(torch.from_numpy(x).chunk(n)))]


CASES = {
    "ring_pass": (lambda x: jcol.ring_pass(x, "x"), lambda xs: tcol.ring_pass(xs)),
    "ring_pass_back": (lambda x: jcol.ring_pass(x, "x", shift=-1),
                       lambda xs: tcol.ring_pass(xs, shift=-1)),
    "all_gather_0": (lambda x: jcol.all_gather(x, "x", axis=0),
                     lambda xs: tcol.all_gather(xs, axis=0)),
    "all_gather_2": (lambda x: jcol.all_gather(x, "x", axis=2),
                     lambda xs: tcol.all_gather(xs, axis=2)),
    "all_gather_untiled": (lambda x: jcol.all_gather(x, "x", axis=1, tiled=False)[:1],
                           lambda xs: [y[:1] for y in tcol.all_gather(xs, axis=1,
                                                                      tiled=False)]),
    "all_to_all_1_2": (lambda x: jcol.all_to_all(x, "x", split_axis=1, concat_axis=2),
                       lambda xs: tcol.all_to_all(xs, split_axis=1, concat_axis=2)),
    "all_to_all_2_1": (lambda x: jcol.all_to_all(x, "x", split_axis=2, concat_axis=1),
                       lambda xs: tcol.all_to_all(xs, split_axis=2, concat_axis=1)),
    "all_to_all_untiled": (
        lambda x: jax.lax.all_to_all(x.reshape(N, -1, 4), "x", 0, 0, tiled=False).reshape(
            3, 8, 4),
        lambda xs: [y.reshape(3, 8, 4) for y in tcol.all_to_all(
            [x.reshape(N, -1, 4) for x in xs], 0, 0, tiled=False)]),
}
SUMS = {
    "all_reduce_sum": (lambda x: jcol.all_reduce_sum(x, "x"), tcol.all_reduce_sum),
    "all_reduce_mean": (lambda x: jcol.all_reduce_mean(x, "x"), tcol.all_reduce_mean),
    "reduce_scatter_1": (lambda x: jcol.reduce_scatter(x, "x", axis=1),
                         lambda xs: tcol.reduce_scatter(xs, axis=1)),
    "reduce_scatter_2": (lambda x: jcol.reduce_scatter(x, "x", axis=2),
                         lambda xs: tcol.reduce_scatter(xs, axis=2)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_moves_are_exact(name):
    jfn, tfn = CASES[name]
    x = _blocks(0)
    got, want = _torch(tfn, x), _jax(jfn, x)
    assert len(got) == len(want) == N
    for g, w in zip(got, want):
        assert g.shape == w.shape and np.array_equal(g, w)


@pytest.mark.parametrize("name", sorted(SUMS))
def test_sums_match(name):
    jfn, tfn = SUMS[name]
    x = _blocks(1)
    got, want = _torch(tfn, x), _jax(jfn, x)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7)
    # Every shard gets the same bits.
    assert all(np.array_equal(got[0], g) for g in got[1:]) or name.startswith("reduce")


@pytest.mark.parametrize("name", ["ring_pass", "all_gather_2", "all_to_all_1_2",
                                  "all_reduce_sum", "reduce_scatter_1"])
def test_gradients_match(name):
    jfn, tfn = dict(CASES, **SUMS)[name]
    x = _blocks(2)
    w = _blocks(3, shape=_torch(tfn, x)[0].shape)

    def jloss(xx):
        out = shard_map(jfn, mesh=_jmesh(), in_specs=P("x"), out_specs=P("x"))(xx)
        return jnp.sum(out * jnp.asarray(w))

    want = np.split(np.asarray(jax.grad(jloss)(jnp.asarray(x))), N)
    xs = [b.clone().requires_grad_(True) for b in torch.from_numpy(x).chunk(N)]
    ws = torch.from_numpy(w).chunk(N)
    sum((y * wb).sum() for y, wb in zip(tfn(xs), ws)).backward()
    for xb, wg in zip(xs, want):
        np.testing.assert_allclose(xb.grad.numpy(), wg, rtol=1e-6, atol=1e-6)


def test_ring_perm_and_axis_index_match():
    seen = {}

    def jfn(x):
        seen["perm"] = jcol.ring_perm("x", 1)
        seen["back"] = jcol.ring_perm("x", -1)
        return jnp.zeros_like(x[:1, :1, :1]) + jcol.axis_index("x")

    index = _jax(jfn, _blocks(4))
    assert tcol.ring_perm(N, 1) == seen["perm"]
    assert tcol.ring_perm(N, -1) == seen["back"]
    got = tcol.axis_index(list(torch.zeros(N, 2).chunk(N)))
    assert [g.dtype for g in got] == [torch.int32] * N
    assert [int(g) for g in got] == [int(i.ravel()[0]) for i in index] == list(range(N))


def test_untiled_all_to_all_checks_its_split_axis():
    with pytest.raises(ValueError, match="split axis"):
        tcol.all_to_all([torch.zeros(3, 2)] * 2, 0, 0, tiled=False)
    with pytest.raises(ValueError, match="divide"):
        tcol.all_to_all([torch.zeros(3, 2)] * 2, 0, 1)
