"""The port's sharded train step and mesh forward (nos_tpu_torch/models/
{gpt,train,data}.py with a mesh, parallel/{mesh,sharding}.py) against the
JAX reference on the CPU.

The JAX single-device step is what GSPMD's sharded step computes too; the
port's runs over meshes of `["cpu"] * 4`: dp 2 x tp 2 (flash per shard,
row-parallel sums), dp 2 x sp 2 with ring attention, sp 4 with Ulysses, tp
2 x sp 2 with the sequence gathered for flash. test_torch_train.py's
model, params, batches (2 x 48, seed 3) and bounds: three AdamW steps,
per-step loss rtol 1e-5, the params after step 3 within PARAM_ATOL, the
summed gradients of step 1 within GRAD_ATOL; replicas bit-identical after
every step. Measured: params at most 7.6e-6 from JAX's (the single-device
port 1.06e-5). At batch 4 x 48 the single-device port itself lies 4.6e-4
from JAX after three steps (Adam's m / sqrt(v) on near-zero gradient
entries of tok_emb, see PARAM_ATOL), and the sharded steps 1.4e-4 to
4.1e-4, so that batch does not test the sharding against JAX; there each
mesh is held against the port's own single-device step (BATCH4_TOL)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from nos_tpu.models import data as jdata
from nos_tpu.models import gpt as jgpt
from nos_tpu.models import train as jtrain
from nos_tpu.parallel import mesh as jmesh
from nos_tpu.parallel import sharding as jsh
from nos_tpu_torch.models import data as tdata
from nos_tpu_torch.models import gpt as tgpt
from nos_tpu_torch.models import train as ttrain
from nos_tpu_torch.parallel import (MeshTree, batch_sharding, build_mesh,
                                    build_multislice_mesh, param_shardings, replicated,
                                    transformer_param_rules, unshard_tensor)
from nos_tpu_torch.parallel.sharding import replica_groups, spec_for_path, tree_get, tree_leaves
from test_torch_train import GRAD_ATOL, JCFG, PARAM_ATOL, _port_params, _tcfg

MESHES = {
    "dp2_tp2": ({"dp": 2, "tp": 2}, "flash"),
    "dp2_sp2_ring": ({"dp": 2, "sp": 2}, "ring"),
    "sp4_ulysses": ({"sp": 4}, "ulysses"),
    "tp2_sp2_flash": ({"tp": 2, "sp": 2}, "flash"),
}


def _mesh(axes):
    return build_mesh(axes, devices=["cpu"] * 4)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def jparams():
    return jgpt.init_gpt(jax.random.PRNGKey(0), JCFG)


def _batches(steps=3, batch=2):
    return list(tdata.synthetic_token_stream(JCFG.vocab, batch, 48, seed=3, steps=steps))


# Batch 4 x 48, each mesh against the port's single-device step (the same
# summation orders but the sharded sums'). Measured over the four meshes:
# the summed gradients of step 1 at most 8.9e-7 apart (held to GRAD_ATOL);
# after three AdamW steps the per-step loss 7.9e-6 relative, the params
# 3.8e-4 (Adam's m / sqrt(v) turns the sums' rounding on near-zero
# gradient entries into updates of up to lr either way), the difference of
# the two updates over the single-device update 1.9e-3 as norms over every
# leaf (dp2_tp2 and tp2_sp2_flash; ring 2.1e-4). Pinned at about 2x.
BATCH4_TOL = {"loss_rtol": 2e-5, "param_atol": 8e-4, "update_rel": 4e-3}


def _check_replicas(params: MeshTree):
    for path, spec in tree_leaves(params.specs):
        leaves = params.leaves(path)
        for group in replica_groups(params.mesh, spec):
            for p in group[1:]:
                assert torch.equal(leaves[p], leaves[group[0]]), (path, p)


@pytest.mark.parametrize("name", sorted(MESHES))
def test_three_sharded_steps_match_reference(jparams, name):
    axes, attention = MESHES[name]
    mesh = _mesh(axes)
    cfg = dataclasses.replace(_tcfg(JCFG), attention=attention)
    tcfg = ttrain.TrainConfig(model=cfg, loss_chunk=16)
    jcfg = jtrain.TrainConfig(model=JCFG, loss_chunk=16)
    jstep = jtrain.make_train_step(jcfg)
    jp, jopt = jparams, jtrain.make_optimizer(jcfg).init(jparams)
    single = _port_params(jparams, cfg)
    sopt = ttrain.make_optimizer(tcfg, single)
    sstep = ttrain.make_train_step(tcfg)
    sharded = param_shardings(_port_params(jparams, cfg), mesh)
    mopt = ttrain.make_optimizer(tcfg, sharded)
    mstep = ttrain.make_train_step(tcfg, mesh)
    for batch in _batches():
        jp, jopt, jm = jstep(jp, jopt, jnp.asarray(batch))
        single, sopt, sm = sstep(single, sopt, torch.from_numpy(batch))
        sharded, mopt, mm = mstep(sharded, mopt, torch.from_numpy(batch))
        np.testing.assert_allclose(mm["loss"].item(), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(mm["loss"].item(), sm["loss"].item(), rtol=1e-5)
        _check_replicas(sharded)
    got = sharded.gather()
    for path, want in tree_leaves(_np_tree(jp)):
        np.testing.assert_allclose(tree_get(got, path).numpy(), want, atol=PARAM_ATOL, rtol=0,
                                   err_msg=path)
        np.testing.assert_allclose(tree_get(got, path).numpy(),
                                   tree_get(single, path).detach().numpy(), atol=PARAM_ATOL,
                                   rtol=0, err_msg=path)


@pytest.mark.parametrize("name", sorted(MESHES))
def test_sharded_steps_at_batch_4_match_single_device(jparams, name):
    axes, attention = MESHES[name]
    mesh = _mesh(axes)
    cfg = dataclasses.replace(_tcfg(JCFG), attention=attention)
    tcfg = ttrain.TrainConfig(model=cfg, loss_chunk=16)
    batches = _batches(batch=4)
    first = torch.from_numpy(batches[0])
    single = _port_params(jparams, cfg)
    sharded = param_shardings(_port_params(jparams, cfg), mesh)
    for leaf in ttrain._leaves(single) + ttrain._leaves(sharded):
        leaf.requires_grad_(True)
    tgpt.gpt_loss(single, first, cfg, loss_chunk=16).backward()
    tgpt.gpt_loss(sharded, first, cfg, mesh, loss_chunk=16).backward()
    ttrain._sum_replica_grads(sharded)
    for path, spec in tree_leaves(sharded.specs):
        got = unshard_tensor([x.grad for x in sharded.leaves(path)], mesh, spec)
        np.testing.assert_allclose(got.numpy(), tree_get(single, path).grad.numpy(), rtol=0,
                                   atol=GRAD_ATOL, err_msg=path)

    start = _port_params(jparams, cfg)
    single = _port_params(jparams, cfg)
    sopt, sstep = ttrain.make_optimizer(tcfg, single), ttrain.make_train_step(tcfg)
    sharded = param_shardings(_port_params(jparams, cfg), mesh)
    mopt, mstep = ttrain.make_optimizer(tcfg, sharded), ttrain.make_train_step(tcfg, mesh)
    for batch in batches:
        single, sopt, sm = sstep(single, sopt, torch.from_numpy(batch))
        sharded, mopt, mm = mstep(sharded, mopt, torch.from_numpy(batch))
        np.testing.assert_allclose(mm["loss"].item(), sm["loss"].item(),
                                   rtol=BATCH4_TOL["loss_rtol"])
        _check_replicas(sharded)
    got = sharded.gather()
    diff_sq = upd_sq = 0.0
    for path, want in tree_leaves(single):
        want = want.detach().double()
        np.testing.assert_allclose(tree_get(got, path).numpy(), want.numpy(),
                                   atol=BATCH4_TOL["param_atol"], rtol=0, err_msg=path)
        diff_sq += ((tree_get(got, path).double() - want) ** 2).sum().item()
        upd_sq += ((want - tree_get(start, path).double()) ** 2).sum().item()
    assert (diff_sq / upd_sq) ** 0.5 <= BATCH4_TOL["update_rel"]


@pytest.mark.parametrize("name", ["dp2_tp2", "dp2_sp2_ring"])
def test_summed_gradients_match_reference(jparams, name):
    """The step's explicit gradient sum (before the clip): every copy of a
    block holds the global gradient, and the distinct blocks' norm is the
    reference's global norm."""
    axes, attention = MESHES[name]
    mesh = _mesh(axes)
    cfg = dataclasses.replace(_tcfg(JCFG), attention=attention)
    batch = _batches(1)[0]
    jl, jg = jax.value_and_grad(lambda p: jgpt.gpt_loss(p, jnp.asarray(batch), JCFG,
                                                        loss_chunk=16))(jparams)
    sharded = param_shardings(_port_params(jparams, cfg), mesh)
    for leaf in ttrain._leaves(sharded):
        leaf.requires_grad_(True)
    loss = tgpt.gpt_loss(sharded, torch.from_numpy(batch), cfg, mesh, loss_chunk=16)
    loss.backward()
    blocks = ttrain._sum_replica_grads(sharded)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    for path, want in tree_leaves(_np_tree(jg)):
        grads = [x.grad for x in sharded.leaves(path)]
        spec = tree_get(sharded.specs, path)
        got = unshard_tensor(grads, mesh, spec)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=GRAD_ATOL, err_msg=path)
        for group in replica_groups(mesh, spec):
            assert all(torch.equal(grads[p], grads[group[0]]) for p in group)
    jnorm = float(jnp.sqrt(sum(jnp.sum(g * g) for g in jax.tree_util.tree_leaves(jg))))
    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(b) for b in blocks]))
    np.testing.assert_allclose(norm.item(), jnorm, rtol=1e-5)
    assert jnorm > 1.0  # the clip divides at this step


def test_mesh_forward_matches_single_device(jparams):
    """gpt_forward / gpt_hidden with a mesh and a plain param tree (placed
    by the rules) give the single-device logits, globally laid out."""
    tokens = torch.from_numpy(_batches(1)[0])
    want = np.asarray(jgpt.gpt_forward(jparams, jnp.asarray(tokens.numpy()), JCFG))
    for name, (axes, attention) in MESHES.items():
        cfg = dataclasses.replace(_tcfg(JCFG), attention=attention)
        got = tgpt.gpt_forward(_port_params(jparams, cfg), tokens, cfg, mesh=_mesh(axes))
        assert got.dtype == torch.float32 and tuple(got.shape) == (2, 48, JCFG.vocab)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0, err_msg=name)
    hidden = tgpt.gpt_hidden(_port_params(jparams, _tcfg(JCFG)), tokens, _tcfg(JCFG),
                             mesh=_mesh({"dp": 2, "tp": 2}))
    plain = tgpt.gpt_hidden(_port_params(jparams, _tcfg(JCFG)), tokens, _tcfg(JCFG))
    np.testing.assert_allclose(hidden.numpy(), plain.detach().numpy(), atol=1e-5, rtol=0)


@pytest.mark.parametrize("lever", ["remat_blocks", "fuse_projections"])
def test_levers_under_a_mesh_leave_the_loss_unchanged(jparams, lever):
    mesh = _mesh({"dp": 2, "tp": 2})
    tokens = torch.from_numpy(_batches(1)[0])
    cfg = _tcfg(JCFG)
    base = tgpt.gpt_loss(_port_params(jparams, cfg), tokens, cfg, mesh, loss_chunk=16)
    other = dataclasses.replace(cfg, **{lever: True})
    got = tgpt.gpt_loss(_port_params(jparams, other), tokens, other, mesh, loss_chunk=16)
    np.testing.assert_allclose(got.item(), base.item(), rtol=1e-6)


def test_init_train_state_on_a_mesh_and_prefetched_batches():
    """init_train_state(mesh=) places one tree per position by the rules;
    the step takes prefetch_to_mesh's blocks as it takes a global batch."""
    mesh = _mesh({"dp": 2, "tp": 2})
    tcfg = ttrain.TrainConfig(model=_tcfg(JCFG), loss_chunk=16)
    params, opt = ttrain.init_train_state(tcfg, torch.Generator().manual_seed(0), mesh=mesh)
    assert isinstance(params, MeshTree) and len(params.shards) == 4
    assert tree_get(params.specs, "layers/0/wq") == (None, "tp")
    assert tree_get(params.specs, "layers/0/wo") == ("tp", None)
    assert tree_get(params.specs, "ln_f/scale") == ()
    assert tuple(params.shards[3]["layers"]["0"]["wq"].shape) == (64, 32)
    assert len(opt.param_groups[0]["params"]) == 4 * (3 + 9 * JCFG.layers)
    twin, topt = ttrain.init_train_state(tcfg, torch.Generator().manual_seed(0), mesh=mesh)
    step = ttrain.make_train_step(tcfg, mesh)
    batches = _batches(2)
    fed = tdata.prefetch_to_mesh(iter(batches), mesh, batch_sharding(mesh, "dp", "sp"))
    for batch, blocks in zip(batches, fed):
        _, _, a = step(params, opt, torch.from_numpy(batch))
        _, _, b = step(twin, topt, blocks)
        assert a["loss"].item() == b["loss"].item()
    with pytest.raises(ValueError, match="pass no device"):
        ttrain.init_train_state(tcfg, mesh=mesh, device="cpu")


def test_prefetch_to_mesh_matches_reference():
    """Each array of each batch becomes its blocks under the spec, block p
    the same values as the reference's shard on device p; order kept."""
    batches = list(jdata.synthetic_token_stream(50, 4, 8, seed=1, steps=3))
    jm = jmesh.build_mesh({"dp": 2, "sp": 2})
    tm = _mesh({"dp": 2, "sp": 2})
    want = list(jdata.prefetch_to_mesh(iter(batches), jm, P("dp", "sp")))
    got = list(tdata.prefetch_to_mesh(({"t": b, "pair": (b, b)} for b in batches), tm,
                                      ("dp", "sp"), size=2))
    assert len(got) == 3
    for item, jarr, b in zip(got, want, batches):
        blocks = item["t"]
        assert len(blocks) == 4 and isinstance(item["pair"], tuple)
        shards = {s.device: np.asarray(s.data) for s in jarr.addressable_shards}
        for p, block in enumerate(blocks):
            assert block.dtype == torch.int32 and block.is_contiguous()
            assert np.array_equal(block.numpy(), shards[jm.devices.ravel()[p]])
        assert np.array_equal(unshard_tensor(blocks, tm, ("dp", "sp")).numpy(), b)
        assert np.array_equal(item["pair"][1][3].numpy(), b[2:, 4:])


def test_transformer_rules_and_placement_match_reference(jparams):
    rules, jrules = transformer_param_rules(), jsh.transformer_param_rules()
    for path in ("layers/0/wq", "layers/11/wo", "layers/3/w_down", "layers/2/w_gate",
                 "ln_f/scale", "tok_emb", "lm_head", "patch_emb", "layers/1/fc1",
                 "class_head", "box_head", "layers/0/ln1/scale"):
        assert spec_for_path(path, rules) == tuple(jsh.spec_for_path(path, jrules)), path
    for axes in ({"dp": 2, "tp": 4}, {"tp": 8}, {"dp": 8}):
        jm = jmesh.build_mesh(axes)
        tm = build_mesh(axes, devices=["cpu"] * 8)
        jspecs = jsh.param_partition_specs(jparams, jm, jrules)
        placed = param_shardings(_port_params(jparams, _tcfg(JCFG)), tm)
        for path, spec in tree_leaves(placed.specs):
            assert spec == tuple(tree_get(jspecs, path)), (axes, path)
            jarr = jax.device_put(tree_get(jparams, path), NamedSharding(jm, tree_get(jspecs,
                                                                                      path)))
            shards = {s.device: np.asarray(s.data) for s in jarr.addressable_shards}
            for p, block in enumerate(placed.leaves(path)):
                assert np.array_equal(block.numpy(), shards[jm.devices.ravel()[p]])
    assert replicated(tm) == ()
    assert batch_sharding(tm) == ("dp",) and batch_sharding(tm, sp_axis="sp") == ("dp",)


def test_multislice_mesh_matches_reference():
    for kw in (dict(ici_axes={"tp": 2, "dp": -1}, num_slices=2), dict(ici_axes={"dp": -1}),
               dict(ici_axes={"tp": 4}, num_slices=2, dcn_axis="slice")):
        jm = jmesh.build_multislice_mesh(**kw)
        tm = build_multislice_mesh(devices=["cpu"] * 8, **kw)
        assert tm.axis_names == jm.axis_names and tm.shape == dict(jm.shape)
    tm = build_multislice_mesh({"tp": 2, "dp": -1}, num_slices=2,
                               devices=[f"cpu:{i}" for i in range(8)])
    assert [str(d) for d in tm.axis_devices("dcn")] == ["cpu:0", "cpu:4"]
    assert tm.groups("tp")[:2] == [[0, 2], [1, 3]]
    with pytest.raises(ValueError, match="not divisible"):
        build_multislice_mesh({"dp": -1}, num_slices=3, devices=["cpu"] * 8)
    with pytest.raises(ValueError, match="must multiply"):
        build_multislice_mesh({"tp": 3}, num_slices=2, devices=["cpu"] * 8)
    with pytest.raises(ValueError, match="at most one"):
        build_multislice_mesh({"tp": -1, "dp": -1}, devices=["cpu"] * 8)


def test_tp_needs_the_megatron_layout(jparams):
    """A tp mesh whose rules leave a projection replicated is refused
    instead of computing with the wrong blocks."""
    mesh = _mesh({"dp": 2, "tp": 2})
    cfg = _tcfg(JCFG)
    placed = param_shardings(_port_params(jparams, cfg), mesh, rules=((r".*", ()),))
    with pytest.raises(ValueError, match="needs wq sharded"):
        tgpt.gpt_loss(placed, torch.from_numpy(_batches(1)[0]), cfg, mesh)
