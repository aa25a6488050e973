"""The port's ring and Ulysses attention (nos_tpu_torch/parallel/
ring_attention.py) against the JAX package's (nos_tpu/parallel/
ring_attention.py) on the CPU: the JAX functions on the virtual devices,
the port's on meshes of `["cpu"] * n`, the same numpy q/k/v. f32 within
atol 1e-5 (forward and the gradient of a weighted sum); bf16, where q's
scale is rounded before any product, within one bf16 step of the
entry (2^-7 relative, atol 1e-2)."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from nos_tpu.parallel import mesh as jmesh
from nos_tpu_torch.parallel import build_mesh

# The packages export a function of the module's name: take the modules.
jra = importlib.import_module("nos_tpu.parallel.ring_attention")
tra = importlib.import_module("nos_tpu_torch.parallel.ring_attention")

ATOL = 1e-5


def _qkv(shape, seed, dtype=np.float32):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32) for _ in range(3)]


def _jax(fn, qkv, axes, causal, dtype=jnp.float32):
    mesh = jmesh.build_mesh(axes)
    dp = "dp" if "dp" in axes else None
    spec = NamedSharding(mesh, P(dp, None, "sp", None))
    q, k, v = (jax.device_put(jnp.asarray(x, dtype), spec) for x in qkv)
    return np.asarray(fn(q, k, v, mesh=mesh, causal=causal).astype(jnp.float32))


def _port(fn, qkv, axes, causal, dtype=torch.float32):
    mesh = build_mesh(axes, devices=["cpu"] * int(np.prod(list(axes.values()))))
    q, k, v = (torch.from_numpy(x).to(dtype) for x in qkv)
    return fn(q, k, v, mesh=mesh, causal=causal).float().numpy()


@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_matches_reference(causal):
    qkv = _qkv((2, 4, 64, 16), 1)
    want = _jax(jra.ring_attention, qkv, {"sp": 8}, causal)
    got = _port(tra.ring_attention, qkv, {"sp": 8}, causal)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    plain = tra.reference_attention(*(torch.from_numpy(x) for x in qkv), causal=causal)
    np.testing.assert_allclose(got, plain.numpy(), atol=ATOL, rtol=0)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_with_dp_axis(causal):
    qkv = _qkv((4, 2, 32, 8), 2)
    want = _jax(jra.ring_attention, qkv, {"dp": 2, "sp": 4}, causal)
    got = _port(tra.ring_attention, qkv, {"dp": 2, "sp": 4}, causal)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("causal", [False, True])
def test_ulysses_attention_matches_reference(causal):
    qkv = _qkv((2, 8, 32, 16), 3)
    want = _jax(jra.ulysses_attention, qkv, {"sp": 4}, causal)
    got = _port(tra.ulysses_attention, qkv, {"sp": 4}, causal)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    want_dp = _jax(jra.ulysses_attention, qkv, {"dp": 2, "sp": 4}, causal)
    got_dp = _port(tra.ulysses_attention, qkv, {"dp": 2, "sp": 4}, causal)
    np.testing.assert_allclose(got_dp, want_dp, atol=ATOL, rtol=0)


@pytest.mark.parametrize("fn", ["ring_attention", "ulysses_attention"])
def test_bf16_within_a_step_of_reference(fn):
    qkv = _qkv((2, 4, 64, 16), 4)
    want = _jax(getattr(jra, fn), qkv, {"sp": 4}, True, jnp.bfloat16)
    got = _port(getattr(tra, fn), qkv, {"sp": 4}, True, torch.bfloat16)
    np.testing.assert_allclose(got, want, rtol=2.0 ** -7, atol=1e-2)


def test_reference_attention_matches():
    qkv = _qkv((2, 3, 20, 8), 5)
    for causal in (False, True):
        want = np.asarray(jra.reference_attention(*map(jnp.asarray, qkv), causal=causal))
        got = tra.reference_attention(*map(torch.from_numpy, qkv), causal=causal).numpy()
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_ring_gradient_matches_reference():
    qkv = _qkv((2, 2, 32, 8), 6)
    w = np.random.RandomState(7).randn(2, 2, 32, 8).astype(np.float32)
    mesh = jmesh.build_mesh({"sp": 4})
    spec = NamedSharding(mesh, P(None, None, "sp", None))

    def jloss(q, k, v):
        return jnp.sum(jra.ring_attention(q, k, v, mesh=mesh, causal=True) * w)

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        *(jax.device_put(jnp.asarray(x), spec) for x in qkv))
    tmesh = build_mesh({"sp": 4}, devices=["cpu"] * 4)
    ts = [torch.from_numpy(x).requires_grad_(True) for x in qkv]
    (tra.ring_attention(*ts, mesh=tmesh, causal=True) * torch.from_numpy(w)).sum().backward()
    for t, g in zip(ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), atol=ATOL, rtol=0)


def test_ulysses_needs_heads_divisible_by_sp():
    mesh = build_mesh({"sp": 4}, devices=["cpu"] * 4)
    q = torch.zeros(1, 6, 8, 4)
    with pytest.raises(ValueError, match="heads 6 not divisible"):
        tra.ulysses_attention(q, q, q, mesh=mesh)
