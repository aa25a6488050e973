"""The port's model math (nos_tpu_torch/models/gpt.py, params.py) against
the JAX reference (nos_tpu/models/gpt.py) on the CPU: same numpy inputs,
same weights carried across with `from_numpy_params`, atol 1e-5 (float32
on both sides; the gap is summation order and transcendental ulps)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nos_tpu.models import gpt as jgpt
from nos_tpu_torch.models import gpt as tgpt
from nos_tpu_torch.models.params import from_numpy_params

from conftest import serving_test_config

ATOL = 1e-5


def _tcfg(jcfg):
    return tgpt.GPTConfig(**dataclasses.asdict(jcfg))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_config_fields_and_properties_match():
    jcfg = jgpt.GPTConfig(vocab=32000, hidden=512, layers=8, heads=8, kv_heads=2,
                          max_seq=8192)
    tcfg = _tcfg(jcfg)
    # The reference's fields, in its order, then the port's serving layouts'
    # (head size, layer kinds, YaRN on the full layers, experts), which
    # default off.
    ref = [f.name for f in dataclasses.fields(jcfg)]
    assert [f.name for f in dataclasses.fields(tcfg)] == ref + [
        "head_size", "layer_types", "sliding_window", "rope_yarn", "n_experts", "top_k",
        "expert_ffn", "norm_topk_prob"]
    assert not tcfg.mixed
    assert (tcfg.head_dim, tcfg.n_kv) == (jcfg.head_dim, jcfg.n_kv) == (64, 2)
    assert tcfg.torch_dtype == torch.bfloat16
    with pytest.raises(ValueError):
        tgpt.GPTConfig(heads=8, kv_heads=3).n_kv
    for tp in (1, 2):
        port = dataclasses.asdict(tgpt.tp_local_config(tcfg, tp))
        assert {k: port[k] for k in ref} == dataclasses.asdict(jgpt.tp_local_config(jcfg, tp))
    with pytest.raises(ValueError):
        tgpt.tp_local_config(tcfg, 3)


def test_rmsnorm_matches_reference():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 5, 32).astype(np.float32)
    scale = rng.randn(32).astype(np.float32)
    want = jgpt._rmsnorm(jnp.asarray(x), {"scale": jnp.asarray(scale)})
    got = tgpt._rmsnorm(torch.from_numpy(x), {"scale": torch.from_numpy(scale)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("theta", [10000.0, 500000.0])
def test_rope_matches_reference(theta):
    rng = np.random.RandomState(1)
    x = rng.randn(2, 3, 7, 16).astype(np.float32)
    positions = rng.randint(0, 8192, size=(2, 7)).astype(np.int32)
    want = jgpt._rope(jnp.asarray(x), jnp.asarray(positions), theta)
    got = tgpt._rope(torch.from_numpy(x), torch.from_numpy(positions), theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("fuse", [False, True])
@pytest.mark.parametrize("repeat_kv", [False, True])
def test_project_qkv_matches_reference(fuse, repeat_kv):
    jcfg = dataclasses.replace(serving_test_config(), fuse_projections=fuse)
    tcfg = _tcfg(jcfg)
    jparams = jgpt.init_gpt(jax.random.PRNGKey(3), jcfg)
    tparams = from_numpy_params(_np_tree(jparams), tcfg, device="cpu")
    rng = np.random.RandomState(2)
    x = rng.randn(2, 6, jcfg.hidden).astype(np.float32)
    positions = np.tile(np.arange(6, dtype=np.int32) + 5, (2, 1))
    want = jgpt.project_qkv(jnp.asarray(x), jparams["layers"]["0"], jcfg,
                            jnp.asarray(positions), repeat_kv=repeat_kv)
    got = tgpt.project_qkv(torch.from_numpy(x), tparams["layers"]["0"], tcfg,
                           torch.from_numpy(positions), repeat_kv=repeat_kv)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=0)


def test_from_numpy_params_carries_bf16_bits_exactly():
    jcfg = dataclasses.replace(serving_test_config(), dtype="bfloat16")
    jparams = jgpt.init_gpt(jax.random.PRNGKey(0), jcfg)
    tparams = from_numpy_params(_np_tree(jparams), _tcfg(jcfg), device="cpu")
    want = np.asarray(jparams["layers"]["1"]["wq"]).astype(np.float32)
    got = tparams["layers"]["1"]["wq"]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_init_gpt_shapes_and_scales_match_reference():
    jcfg = jgpt.GPTConfig(vocab=512, hidden=64, layers=2, heads=4, kv_heads=2,
                          dtype="float32")
    jparams = _np_tree(jgpt.init_gpt(jax.random.PRNGKey(0), jcfg))
    tparams = tgpt.init_gpt(_tcfg(jcfg), torch.Generator().manual_seed(0), device="cpu")
    jflat = jax.tree_util.tree_leaves_with_path(jparams)
    for path, leaf in jflat:
        node = tparams
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape, path
        # Same init scale: std within 10% (ones for the norm scales).
        np.testing.assert_allclose(node.float().std().item(), leaf.std(), rtol=0.1,
                                   atol=1e-6)
    again = tgpt.init_gpt(_tcfg(jcfg), torch.Generator().manual_seed(0), device="cpu")
    assert torch.equal(again["lm_head"], tparams["lm_head"])
