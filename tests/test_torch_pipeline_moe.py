"""The port's pipeline and MoE (nos_tpu_torch/parallel/{pipeline,moe}.py)
against the JAX package's (nos_tpu/parallel/{pipeline,moe}.py) on the CPU,
on the scenarios of tests/test_pipeline_moe.py.

The JAX functions run on the virtual devices, the port's on meshes of
`["cpu"] * n`; params and inputs are the same numpy arrays. Pipeline:
outputs and gradients atol 1e-5. MoE: the kept mask (which (token, choice)
found capacity) equal exactly, outputs atol 1e-5, the aux loss rtol 1e-6,
and the reference's overflow, validation and aux-loss scenarios."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nos_tpu.parallel.mesh import build_mesh as jbuild_mesh
from nos_tpu.parallel.moe import init_moe as jinit_moe, moe_apply as jmoe_apply
from nos_tpu.parallel.pipeline import pipeline_apply as jpipeline_apply
from nos_tpu_torch.parallel import build_mesh, shard_tensor
from nos_tpu_torch.parallel import moe as tmoe
from nos_tpu_torch.parallel.pipeline import pipeline_apply

ATOL = 1e-5


def _mesh(axes):
    return build_mesh(axes, devices=["cpu"] * int(np.prod(list(axes.values()))))


def _t(x):
    return torch.from_numpy(np.array(x))


# -- pipeline ------------------------------------------------------------------
def test_pipeline_matches_sequential_and_reference():
    rng = np.random.RandomState(0)
    w = (rng.randn(4, 8, 8) * 0.3).astype(np.float32)
    b = (rng.randn(4, 8) * 0.1).astype(np.float32)
    batch = rng.randn(8, 8).astype(np.float32)

    def jstage(p, x):
        return jnp.tanh(x @ p["w"] + p["b"])

    def tstage(p, x):
        return torch.tanh(x @ p["w"] + p["b"])

    want = np.asarray(jpipeline_apply({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                                      jnp.asarray(batch), jstage, jbuild_mesh({"pp": 4}),
                                      n_microbatches=4))
    got = pipeline_apply({"w": _t(w), "b": _t(b)}, _t(batch), tstage, _mesh({"pp": 4}),
                         n_microbatches=4)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    ref = _t(batch)
    for s in range(4):
        ref = tstage({"w": _t(w[s]), "b": _t(b[s])}, ref)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=ATOL, rtol=0)


def test_pipeline_with_dp_axis_and_grad(n_microbatches=2):
    rng = np.random.RandomState(1)
    w = (rng.randn(2, 4, 4) * 0.3).astype(np.float32)
    batch = rng.randn(8, 4).astype(np.float32)
    jmesh = jbuild_mesh({"pp": 2, "dp": 4})

    def jloss(params, x):
        out = jpipeline_apply(params, x, lambda p, y: jnp.tanh(y @ p["w"]), jmesh,
                              n_microbatches=n_microbatches)
        return jnp.mean(out ** 2)

    jval, jgrads = jax.value_and_grad(jloss)({"w": jnp.asarray(w)}, jnp.asarray(batch))
    tw = _t(w).requires_grad_(True)
    out = pipeline_apply({"w": tw}, _t(batch), lambda p, y: torch.tanh(y @ p["w"]),
                         _mesh({"pp": 2, "dp": 4}), n_microbatches=n_microbatches)
    loss = (out ** 2).mean()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jval), atol=ATOL, rtol=0)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jgrads["w"]), atol=ATOL, rtol=0)
    # And the sequential model's gradient.
    sw = _t(w).requires_grad_(True)
    ref = _t(batch)
    for s in range(2):
        ref = torch.tanh(ref @ sw[s])
    (ref ** 2).mean().backward()
    np.testing.assert_allclose(tw.grad.numpy(), sw.grad.numpy(), atol=ATOL, rtol=0)


def test_pipeline_rejects_an_uneven_batch():
    with pytest.raises(ValueError, match="microbatches"):
        pipeline_apply({"w": torch.zeros(2, 2, 2)}, torch.zeros(5, 2), lambda p, x: x,
                       _mesh({"pp": 2}))


# -- MoE ---------------------------------------------------------------------------
def _moe_params(seed, hidden=16, mlp_dim=32, n_experts=4):
    jp = jinit_moe(jax.random.PRNGKey(seed), hidden=hidden, mlp_dim=mlp_dim,
                   n_experts=n_experts, dtype=jnp.float32)
    return jp, {k: _t(v) for k, v in jp.items()}


def _x(seed, shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _jax_kept(jparams, x, ep, capacity, top_k):
    """The reference's choice-major capacity assignment (moe.py:55-80) on
    each ep rank's tokens, with JAX's own top_k."""
    b, t, h = x.shape
    n_experts = jparams["w_in"].shape[0]
    kept_all = []
    for r in range(ep):
        flat = jnp.asarray(x[:, r * t // ep:(r + 1) * t // ep].reshape(-1, h))
        probs = jax.nn.softmax(flat @ jparams["router"], axis=-1)
        _, idx = jax.lax.top_k(probs, top_k)
        counts = jnp.zeros((n_experts,), jnp.int32)
        kepts = []
        for c in range(top_k):
            onehot = jax.nn.one_hot(idx[:, c], n_experts, dtype=jnp.int32)
            slot = jnp.sum(jnp.cumsum(onehot, axis=0) * onehot, axis=-1) - 1 + counts[idx[:, c]]
            kepts.append(slot < capacity)
            counts = counts + jnp.sum(onehot, axis=0)
        kept_all.append(np.asarray(jnp.stack(kepts, axis=1)))
    return kept_all


def _port_kept(tparams, x, ep, capacity, top_k):
    mesh = _mesh({"ep": ep})
    xs = shard_tensor(_t(x), mesh, (None, "ep", None))
    local = [{"router": tparams["router"], "w_in": wi, "w_out": wo} for wi, wo in zip(
        shard_tensor(tparams["w_in"], mesh, ("ep",)), shard_tensor(tparams["w_out"], mesh,
                                                                   ("ep",)))]
    _, _, kept = tmoe._moe_local(local, [v.reshape(-1, x.shape[-1]) for v in xs],
                                 tparams["w_in"].shape[0], capacity, top_k)
    return [k.numpy() for k in kept]


@pytest.mark.parametrize("top_k,capacity_factor", [(1, 0.5), (2, 0.5)])
def test_moe_matches_reference(top_k, capacity_factor):
    jp, tp = _moe_params(0)
    x = _x(1, (2, 8, 16))
    want, jaux = jmoe_apply(jp, jnp.asarray(x), jbuild_mesh({"ep": 4}), top_k=top_k,
                            capacity_factor=capacity_factor, return_aux=True)
    got, aux = tmoe.moe_apply(tp, _t(x), _mesh({"ep": 4}), top_k=top_k,
                              capacity_factor=capacity_factor, return_aux=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    np.testing.assert_allclose(aux.item(), float(jaux), rtol=1e-6)
    capacity = max(1, int(capacity_factor * top_k * (2 * 8 // 4) / 4))
    kept_j = _jax_kept(jp, x, 4, capacity, top_k)
    kept_t = _port_kept(tp, x, 4, capacity, top_k)
    for kj, kt in zip(kept_j, kept_t):
        assert kt.dtype == np.bool_ and np.array_equal(kt, kj)
    if capacity_factor < 1:
        assert not all(k.all() for k in kept_t)  # the squeeze dropped something


def test_moe_with_dp_axis_matches_reference():
    jp, tp = _moe_params(0, n_experts=8)
    x = _x(2, (4, 8, 16))
    want = jmoe_apply(jp, jnp.asarray(x), jbuild_mesh({"dp": 2, "ep": 4}))
    got = tmoe.moe_apply(tp, _t(x), _mesh({"dp": 2, "ep": 4}))
    assert got.shape == x.shape and bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_moe_rejects_indivisible_and_out_of_range():
    _, tp = _moe_params(0, hidden=8, mlp_dim=16, n_experts=6)
    with pytest.raises(ValueError, match="not divisible by ep"):
        tmoe.moe_apply(tp, torch.zeros(1, 4, 8), _mesh({"ep": 4}))
    _, tp = _moe_params(0)
    with pytest.raises(ValueError, match="top_k"):
        tmoe.moe_apply(tp, torch.zeros(2, 8, 16), _mesh({"ep": 4}), top_k=0)
    with pytest.raises(ValueError, match="top_k"):
        tmoe.moe_apply(tp, torch.zeros(2, 8, 16), _mesh({"ep": 4}), top_k=5)
    with pytest.raises(ValueError, match="sequence 6"):
        tmoe.moe_apply(tp, torch.zeros(2, 6, 16), _mesh({"ep": 4}))


def _ffn(tp, x1d, e):
    mid = torch.nn.functional.gelu(x1d @ tp["w_in"][e], approximate="tanh")
    return mid @ tp["w_out"][e]


def test_moe_top2_matches_dense_reference_with_ample_capacity():
    """top_k 2: each token's output is the renormalized-gate sum of its two
    experts; capacity ample, the reference computed densely."""
    _, tp = _moe_params(0)
    x = _t(_x(1, (2, 8, 16)))
    got = tmoe.moe_apply(tp, x, _mesh({"ep": 4}), capacity_factor=8.0, top_k=2)
    flat = x.reshape(16, 16)
    probs = torch.softmax(flat @ tp["router"], dim=-1)
    gate, idx = tmoe._top_k(probs, 2)
    gate = gate / gate.sum(-1, keepdim=True)
    want = torch.stack([sum(_ffn(tp, flat[i], int(idx[i, c])) * gate[i, c] for c in range(2))
                        for i in range(16)]).reshape(2, 8, 16)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL, rtol=0)


def test_moe_top2_second_choices_overflow_first():
    """Choice-major capacity: at capacity for the first choices only, every
    token's output is one of its legal outcomes and some second choice
    drops."""
    jp, tp = _moe_params(3, hidden=8, mlp_dim=16, n_experts=2)
    x = _x(4, (1, 8, 8))
    got = tmoe.moe_apply(tp, _t(x), _mesh({"ep": 2}), capacity_factor=0.5, top_k=2)
    flat = _t(x).reshape(8, 8)
    probs = torch.softmax(flat @ tp["router"], dim=-1)
    gate, idx = tmoe._top_k(probs, 2)
    gate = gate / gate.sum(-1, keepdim=True)
    dropped_second = 0
    for i in range(8):
        first = _ffn(tp, flat[i], int(idx[i, 0])) * gate[i, 0]
        second = _ffn(tp, flat[i], int(idx[i, 1])) * gate[i, 1]
        cands = {"both": first + second, "first": first, "second": second,
                 "none": torch.zeros_like(first)}
        dists = {k: (got.reshape(8, 8)[i] - v).abs().max().item() for k, v in cands.items()}
        best = min(dists, key=dists.get)
        assert dists[best] < 1e-4, (i, dists)
        dropped_second += best in ("first", "none")
    assert dropped_second > 0


def test_moe_aux_loss_balanced_is_one_and_skew_is_larger():
    """Switch eq. 4: a uniform router (all ties: the stable sort picks the
    lowest experts, as lax.top_k) gives aux 1; a router pinned to one
    expert drives it toward n_experts."""
    _, tp = _moe_params(0)
    x = _x(1, (2, 8, 16))
    uniform_t = dict(tp, router=torch.zeros_like(tp["router"]))
    _, aux_u = tmoe.moe_apply(uniform_t, _t(x), _mesh({"ep": 4}), top_k=2, return_aux=True)
    assert abs(aux_u.item() - 1.0) < 0.3
    biased_t = dict(tp, router=torch.zeros_like(tp["router"]).index_fill(1, torch.tensor([0]),
                                                                         1.0))
    _, aux_b = tmoe.moe_apply(biased_t, torch.ones(2, 8, 16), _mesh({"ep": 4}), top_k=2,
                              return_aux=True)
    assert aux_b.item() > 2.0 and aux_b.item() > aux_u.item()
    ties = torch.zeros(5, 4)
    assert tmoe._top_k(ties, 2)[1].tolist() == [[0, 1]] * 5
    assert np.array_equal(np.asarray(jax.lax.top_k(jnp.zeros((5, 4)), 2)[1]), [[0, 1]] * 5)


def test_moe_top2_grad_flows_to_every_leaf():
    """With ample capacity the layer is the dense gate-weighted sum, so its
    gradient (through both all-to-all hops, the gates and the index_put
    dispatch) must equal the dense reference's; the aux term's gradient
    reaches the router."""
    _, tp = _moe_params(0)
    x = _t(_x(1, (2, 8, 16)))
    leaves = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    y = tmoe.moe_apply(leaves, x, _mesh({"ep": 4}), top_k=2, capacity_factor=8.0)
    (y ** 2).mean().backward()
    dense = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    flat = x.reshape(16, 16)
    gate, idx = tmoe._top_k(torch.softmax(flat @ dense["router"], dim=-1), 2)
    gate = gate / gate.sum(-1, keepdim=True)
    want = torch.stack([sum(_ffn(dense, flat[i], int(idx[i, c])) * gate[i, c]
                            for c in range(2)) for i in range(16)])
    (want ** 2).mean().backward()
    for name, leaf in leaves.items():
        np.testing.assert_allclose(leaf.grad.numpy(), dense[name].grad.numpy(), atol=ATOL,
                                   rtol=0, err_msg=name)
    leaves["router"].grad = None
    _, aux = tmoe.moe_apply(leaves, x, _mesh({"ep": 4}), top_k=2, return_aux=True)
    aux.backward()
    assert bool(torch.isfinite(leaves["router"].grad).all())
    assert leaves["router"].grad.abs().max().item() > 0.0


def test_init_moe_shapes_and_device():
    p = tmoe.init_moe(16, 32, 4, generator=torch.Generator().manual_seed(0), device="cpu")
    assert p["router"].dtype == torch.float32 and tuple(p["router"].shape) == (16, 4)
    assert p["w_in"].dtype == torch.bfloat16 and tuple(p["w_in"].shape) == (4, 16, 32)
    assert tuple(p["w_out"].shape) == (4, 32, 16)
