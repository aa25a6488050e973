"""The port's training path (nos_tpu_torch/models/{gpt,train,data}.py,
runtime/mfu.py) against the JAX reference (nos_tpu/models/{gpt,train,
data}.py, runtime/mfu.py) on the CPU.

One tiny f32 GQA config; the reference's params carried across with
`from_numpy_params`, the same numpy tokens on both sides. Bounds: logits
atol 1e-4; loss rtol 1e-5; gradients rtol 1e-4 / atol GRAD_ATOL (below);
three AdamW steps: per-step loss rtol 1e-5, params after step 3 within
PARAM_ATOL (below). f32 on both sides: the gap is summation order."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nos_tpu.models import data as jdata
from nos_tpu.models import gpt as jgpt
from nos_tpu.models import train as jtrain
from nos_tpu.runtime import mfu as jmfu
from nos_tpu_torch.models import data as tdata
from nos_tpu_torch.models import gpt as tgpt
from nos_tpu_torch.models import train as ttrain
from nos_tpu_torch.models.params import from_numpy_params
from nos_tpu_torch.runtime import mfu as tmfu

JCFG = jgpt.GPTConfig(vocab=256, hidden=64, layers=3, heads=4, kv_heads=2, max_seq=64,
                      dtype="float32")
# Every leaf's gradient differs from the reference's by about 1e-6 of the
# leaf's largest entry (f32 noise of the residual stream's gradient). The
# embedding's largest entry is 1.12, ten times any other leaf's, so its
# worst entry measured 1.7e-6 off: atol 2e-6 (1e-6 was the first bound).
GRAD_ATOL = 2e-6
# Params after three AdamW steps at lr 3e-4: Adam's m / sqrt(v) turns
# gradient noise on near-zero entries into update noise, measured at most
# 1.06e-5. The bound is about 3x that and ten times below one update
# (3e-4), which a flipped or dropped update would move a leaf by.
PARAM_ATOL = 3e-5


def _tcfg(jcfg):
    return tgpt.GPTConfig(**dataclasses.asdict(jcfg))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def model():
    jparams = jgpt.init_gpt(jax.random.PRNGKey(0), JCFG)
    tokens = np.random.RandomState(1).randint(0, JCFG.vocab, (2, 48)).astype(np.int32)
    return jparams, tokens


def _port_params(jparams, cfg):
    return from_numpy_params(_np_tree(jparams), cfg, device="cpu")


def _leaf_pairs(jtree, ttree, prefix=""):
    for key, jv in jtree.items():
        if isinstance(jv, dict):
            yield from _leaf_pairs(jv, ttree[key], f"{prefix}{key}/")
        else:
            yield f"{prefix}{key}", np.asarray(jv), ttree[key]


def test_forward_logits_match_reference(model):
    jparams, tokens = model
    tcfg = _tcfg(JCFG)
    want = jgpt.gpt_forward(jparams, jnp.asarray(tokens), JCFG)
    got = tgpt.gpt_forward(_port_params(jparams, tcfg), torch.from_numpy(tokens), tcfg)
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 48, JCFG.vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


def _jax_loss_and_grads(jparams, tokens, jcfg, chunk):
    return jax.value_and_grad(
        lambda p: jgpt.gpt_loss(p, jnp.asarray(tokens), jcfg, loss_chunk=chunk))(jparams)


def _port_loss_and_grads(jparams, tokens, tcfg, chunk):
    tparams = _port_params(jparams, tcfg)
    for _, _, leaf in _leaf_pairs(_np_tree(jparams), tparams):
        leaf.requires_grad_(True)
    loss = tgpt.gpt_loss(tparams, torch.from_numpy(tokens), tcfg, loss_chunk=chunk)
    loss.backward()
    return loss, tparams


@pytest.mark.parametrize("chunk", [16, 20])  # 47 targets: 20 pads the last chunk
def test_loss_and_every_gradient_match_reference(model, chunk):
    jparams, tokens = model
    jl, jg = _jax_loss_and_grads(jparams, tokens, JCFG, chunk)
    tl, tparams = _port_loss_and_grads(jparams, tokens, _tcfg(JCFG), chunk)
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    n = 0
    for name, want, leaf in _leaf_pairs(jg, tparams):
        np.testing.assert_allclose(leaf.grad.numpy(), want, rtol=1e-4, atol=GRAD_ATOL,
                                   err_msg=name)
        n += 1
    assert n == 4 + 9 * JCFG.layers - 1  # tok_emb, ln_f, lm_head + 9 per layer


@pytest.mark.parametrize("lever", ["remat_blocks", "fuse_projections"])
def test_levers_leave_loss_and_grads_unchanged(model, lever):
    """Activation checkpointing per block and the fused projections change
    no math (tests/test_gpt_model.py holds the reference to the same)."""
    jparams, tokens = model
    tcfg = _tcfg(JCFG)
    l0, p0 = _port_loss_and_grads(jparams, tokens, tcfg, 16)
    l1, p1 = _port_loss_and_grads(jparams, tokens, dataclasses.replace(tcfg, **{lever: True}),
                                  16)
    np.testing.assert_allclose(l1.item(), l0.item(), rtol=1e-6)
    for (name, _, a), (_, _, b) in zip(_leaf_pairs(_np_tree(jparams), p0),
                                       _leaf_pairs(_np_tree(jparams), p1)):
        np.testing.assert_allclose(b.grad.numpy(), a.grad.numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=name)


def test_three_train_steps_match_reference(model):
    """make_train_step on three synthetic_token_stream batches from the same
    params: per-step loss and the params after step 3."""
    jparams, _ = model
    jcfg = jtrain.TrainConfig(model=JCFG, loss_chunk=16)
    tcfg = ttrain.TrainConfig(model=_tcfg(JCFG), loss_chunk=16)
    jstep = jtrain.make_train_step(jcfg)
    jp, jopt = jparams, jtrain.make_optimizer(jcfg).init(jparams)
    tp = _port_params(jparams, tcfg.model)
    topt = ttrain.make_optimizer(tcfg, tp)
    tstep = ttrain.make_train_step(tcfg)
    clipped = 0
    for batch in tdata.synthetic_token_stream(JCFG.vocab, 2, 48, seed=3, steps=3):
        _, jg = _jax_loss_and_grads(jp, batch, JCFG, 16)
        clipped += float(jnp.sqrt(sum(jnp.sum(g * g) for g in jax.tree_util.tree_leaves(jg)))) > 1
        jp, jopt, jm = jstep(jp, jopt, jnp.asarray(batch))
        tp, topt, tm = tstep(tp, topt, torch.from_numpy(batch))
        np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]), rtol=1e-5)
    assert clipped > 0  # the global-norm clip's division ran
    worst = 0.0
    for name, want, leaf in _leaf_pairs(jp, tp):
        worst = max(worst, float(np.abs(leaf.detach().numpy() - want).max()))
    assert worst <= PARAM_ATOL, worst
    start = _np_tree(jparams)
    moved = max(float(np.abs(np.asarray(a) - b).max())
                for (_, a, _), (_, b, _) in zip(_leaf_pairs(jp, tp), _leaf_pairs(start, tp)))
    assert moved > 10 * PARAM_ATOL  # three updates moved the params far past the bound


def test_synthetic_token_stream_bit_identical():
    want = list(jdata.synthetic_token_stream(1000, 3, 17, seed=7, steps=4))
    got = list(tdata.synthetic_token_stream(1000, 3, 17, seed=7, steps=4))
    assert len(got) == 4
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.int32 and np.array_equal(a, b)


def test_prefetch_to_device_keeps_order_and_values():
    batches = list(tdata.synthetic_token_stream(50, 2, 5, seed=1, steps=5))
    got = list(tdata.prefetch_to_device(({"tokens": b, "pair": (b, b)} for b in batches),
                                        size=2, device="cpu"))
    assert len(got) == 5
    for item, b in zip(got, batches):
        assert isinstance(item["tokens"], torch.Tensor) and item["tokens"].dtype == torch.int32
        assert np.array_equal(item["tokens"].numpy(), b)
        assert isinstance(item["pair"], tuple) and np.array_equal(item["pair"][1].numpy(), b)


@pytest.mark.parametrize("cfg", [
    dict(hidden=2048, layers=8),
    dict(hidden=512, layers=8, heads=8, kv_heads=2, max_seq=8192),
    dict(vocab=256, hidden=64, layers=3, heads=4, kv_heads=2, mlp_ratio=2),
])
def test_gpt_train_flops_matches_reference(cfg):
    jcfg = jgpt.GPTConfig(**cfg)
    for batch, seq in ((8, 2048), (2, 48)):
        assert tmfu.gpt_train_flops(_tcfg(jcfg), batch, seq) == jmfu.gpt_train_flops(
            jcfg, batch, seq)
    assert tmfu.flash_pair_floor_ms(8, 8, 2048, 256, 989e12) == jmfu.flash_pair_floor_ms(
        8, 8, 2048, 256, 989e12)


def test_train_config_matches_reference():
    assert [f.name for f in dataclasses.fields(ttrain.TrainConfig)] == [
        f.name for f in dataclasses.fields(jtrain.TrainConfig)]
    t, j = ttrain.TrainConfig(), jtrain.TrainConfig()
    assert (t.learning_rate, t.weight_decay, t.grad_clip, t.loss_chunk) == (
        j.learning_rate, j.weight_decay, j.grad_clip, j.loss_chunk)
    # The port's config has the reference's fields at equal values, and
    # beside them only its serving layouts' (head size, layer kinds,
    # YaRN on the full layers, experts), at defaults that add nothing.
    port, ref = dataclasses.asdict(t.model), dataclasses.asdict(j.model)
    assert {k: port[k] for k in ref} == ref
    assert set(port) - set(ref) == {
        "head_size", "layer_types", "sliding_window", "rope_yarn", "n_experts", "top_k",
        "expert_ffn", "norm_topk_prob"}
    assert not t.model.mixed and t.model.head_dim == j.model.head_dim


@pytest.mark.parametrize("entry", ["init_train_state", "synthetic_batch", "prefetch_to_device"])
def test_entry_points_without_device_raise_without_cuda(monkeypatch, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ttrain.TrainConfig(model=_tcfg(JCFG))
    calls = {
        "init_train_state": lambda: ttrain.init_train_state(cfg),
        "synthetic_batch": lambda: ttrain.synthetic_batch(torch.Generator(), cfg.model, 2, 8),
        "prefetch_to_device": lambda: tdata.prefetch_to_device(iter([])),
    }
    with pytest.raises(RuntimeError, match=f"{entry} runs on CUDA"):
        calls[entry]()


def test_init_train_state_on_the_cpu():
    cfg = ttrain.TrainConfig(model=_tcfg(JCFG))
    params, opt = ttrain.init_train_state(cfg, torch.Generator().manual_seed(0), device="cpu")
    leaves = ttrain._leaves(params)
    assert all(p.requires_grad and p.device.type == "cpu" for p in leaves)
    assert len(opt.param_groups) == 1 and len(opt.param_groups[0]["params"]) == len(leaves)
    group = opt.param_groups[0]
    assert (group["betas"], group["eps"], group["weight_decay"]) == ((0.9, 0.999), 1e-8, 0.01)
    toks = ttrain.synthetic_batch(torch.Generator().manual_seed(1), cfg.model, 2, 8, "cpu")
    assert toks.dtype == torch.int32 and int(toks.max()) < JCFG.vocab


def test_mesh_paths_run(model):
    """The mesh paths no longer raise (they were refused until the sharded
    step was ported; tests/test_torch_sharded_train.py holds them to the
    reference): a loss over a tp=2 mesh and a sharded step run. Without sp
    in the mesh, or without a mesh, ring and ulysses take flash attention,
    as in the reference."""
    from nos_tpu_torch.parallel import build_mesh

    jparams, tokens = model
    tcfg = dataclasses.replace(_tcfg(JCFG), attention="ring")
    mesh = build_mesh({"tp": 2}, devices=["cpu", "cpu"])
    got = tgpt.gpt_loss(_port_params(jparams, tcfg), torch.from_numpy(tokens), tcfg, mesh=mesh)
    want = tgpt.gpt_loss(_port_params(jparams, tcfg), torch.from_numpy(tokens), tcfg)
    np.testing.assert_allclose(got.item(), want.item(), rtol=1e-6)
    assert callable(ttrain.make_train_step(ttrain.TrainConfig(model=tcfg), mesh=mesh))
    base = tgpt.gpt_forward(_port_params(jparams, tcfg), torch.from_numpy(tokens),
                            _tcfg(JCFG))
    for attention in ("ring", "ulysses"):
        cfg = dataclasses.replace(_tcfg(JCFG), attention=attention)
        got = tgpt.gpt_forward(_port_params(jparams, cfg), torch.from_numpy(tokens), cfg)
        assert torch.equal(got, base)
