"""The port's ViT detector (nos_tpu_torch/models/vit.py) against the JAX
reference (nos_tpu/models/vit.py) on the CPU.

Tiny f32 configs, the reference's params carried across with
`from_numpy_vit_params`, the same numpy images on both sides. Bounds:
logits atol LOGIT_ATOL, boxes atol BOX_ATOL (below), `vit_detect`'s labels
equal, `patchify` exact. Both attention routes: the plain attention below
`_FLASH_MIN_SEQ` and, at a 512-pixel image (1024 patches + det tokens),
the flash route, whose plain version runs on the CPU (the reference's runs
its XLA path there)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nos_tpu.models import vit as jvit
from nos_tpu_torch.models import vit as tvit
from nos_tpu_torch.models.params import from_numpy_vit_params

# f32 on both sides, the gap is summation order. Measured on these configs
# (seeds 0 and 2): logits at most 1.4e-6 (plain route) and 9.5e-7 (flash
# route), boxes 4.8e-7 and 1.5e-7. First set at 1e-4 and 1e-5; pinned at
# about 7x and 4x the worst measured.
LOGIT_ATOL = 1e-5
BOX_ATOL = 2e-6

SHORT = jvit.ViTConfig(image_size=32, patch_size=16, hidden=32, layers=2, heads=2,
                       det_tokens=5, num_classes=7, dtype="float32")
# 32 x 32 patches + 4 detection tokens = 1028 tokens >= _FLASH_MIN_SEQ.
LONG = jvit.ViTConfig(image_size=512, patch_size=16, hidden=32, layers=1, heads=2,
                      det_tokens=4, num_classes=6, dtype="float32")


def _tcfg(jcfg):
    return tvit.ViTConfig(**dataclasses.asdict(jcfg))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _case(jcfg, batch, seed):
    jparams = jvit.init_vit(jax.random.PRNGKey(seed), jcfg)
    images = np.random.RandomState(seed + 1).rand(batch, jcfg.image_size, jcfg.image_size,
                                                  3).astype(np.float32)
    tparams = from_numpy_vit_params(_np_tree(jparams), _tcfg(jcfg), device="cpu")
    return jparams, tparams, images


def test_config_matches_reference():
    t, j = tvit.ViTConfig(), jvit.ViTConfig()
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert (t.n_patches, t.seq_len, t.head_dim) == (j.n_patches, j.seq_len, j.head_dim)
    assert tvit._FLASH_MIN_SEQ == jvit._FLASH_MIN_SEQ == 1024
    assert _tcfg(LONG).seq_len >= tvit._FLASH_MIN_SEQ > _tcfg(SHORT).seq_len


def test_patchify_is_exact():
    cfg = SHORT
    images = np.random.RandomState(0).rand(3, 32, 32, 3).astype(np.float32)
    want = np.asarray(jvit.patchify(jnp.asarray(images), cfg))
    got = tvit.patchify(torch.from_numpy(images), _tcfg(cfg)).numpy()
    assert got.shape == want.shape == (3, 4, 16 * 16 * 3)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("jcfg,batch", [(SHORT, 3), (LONG, 1)], ids=["plain", "flash"])
def test_forward_matches_reference(jcfg, batch, monkeypatch):
    from nos_tpu_torch.ops import flash_attention as fa

    jparams, tparams, images = _case(jcfg, batch, 0)
    want_logits, want_boxes = jvit.vit_forward(jparams, jnp.asarray(images), jcfg)
    calls = []
    real = tvit.flash_attention
    monkeypatch.setattr(tvit, "flash_attention",
                        lambda *a, **k: calls.append(k) or real(*a, **k))
    logits, boxes = tvit.vit_forward(tparams, torch.from_numpy(images), _tcfg(jcfg))
    assert logits.dtype == boxes.dtype == torch.float32
    assert tuple(logits.shape) == (batch, jcfg.det_tokens, jcfg.num_classes)
    assert tuple(boxes.shape) == (batch, jcfg.det_tokens, 4)
    # The flash route runs once a layer, non-causal, only at >= 1024 tokens.
    assert calls == ([{"causal": False}] * jcfg.layers if jcfg is LONG else [])
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), atol=LOGIT_ATOL, rtol=0)
    np.testing.assert_allclose(boxes.numpy(), np.asarray(want_boxes), atol=BOX_ATOL, rtol=0)
    assert fa.LAUNCHES["flash_fwd"] == 0  # the CPU ran the plain version


@pytest.mark.parametrize("jcfg,batch", [(SHORT, 4), (LONG, 1)], ids=["plain", "flash"])
def test_detect_labels_equal_reference(jcfg, batch):
    jparams, tparams, images = _case(jcfg, batch, 2)
    jl, js, jb = jvit.vit_detect(jparams, jnp.asarray(images), jcfg)
    tl, ts, tb = tvit.vit_detect(tparams, torch.from_numpy(images), _tcfg(jcfg))
    assert tl.dtype == torch.int32 and tuple(tl.shape) == tuple(jl.shape)
    assert np.array_equal(tl.numpy(), np.asarray(jl))
    assert int(tl.max()) < jcfg.num_classes - 1  # never the no-object class
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=LOGIT_ATOL, rtol=0)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=BOX_ATOL, rtol=0)


def test_detect_breaks_ties_to_the_lowest_class(monkeypatch):
    """jnp.argmax takes the first maximum; the port's labels too, on logits
    with two- and three-way ties (and the background class tied high)."""
    logits = np.zeros((2, 3, 5), np.float32)
    logits[0, 0, [1, 3]] = 2.0
    logits[0, 1, [0, 2, 3]] = 1.0
    logits[1, 2, [2, 4]] = 3.0  # class 4 is no-object: dropped
    boxes = np.full((2, 3, 4), 0.5, np.float32)
    monkeypatch.setattr(jvit, "vit_forward", lambda p, im, c: (jnp.asarray(logits),
                                                               jnp.asarray(boxes)))
    monkeypatch.setattr(tvit, "vit_forward", lambda p, im, c: (torch.from_numpy(logits),
                                                               torch.from_numpy(boxes)))
    jl, js, _ = jvit.vit_detect(None, None, None)
    tl, ts, _ = tvit.vit_detect(None, None, None)
    assert tl.tolist() == np.asarray(jl).tolist()
    assert tl[0].tolist() == [1, 0, 0] and tl[1, 2].item() == 2
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6)


def test_bf16_detect_output_is_compact_and_bounded():
    """The reference's test_vit_detect_compact_output on the port, in bf16."""
    cfg = tvit.ViTConfig(image_size=32, patch_size=16, hidden=64, layers=1, heads=2,
                         det_tokens=5)
    params = tvit.init_vit(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert params["layers"]["0"]["wq"].dtype == torch.bfloat16
    images = torch.rand((2, 32, 32, 3), generator=torch.Generator().manual_seed(1))
    labels, scores, boxes = tvit.vit_detect(params, images, cfg)
    assert labels.shape == (2, 5) and labels.dtype == torch.int32
    assert scores.shape == (2, 5) and float(scores.min()) >= 0.0
    assert boxes.shape == (2, 5, 4)
    assert int(labels.max()) < cfg.num_classes - 1
    assert float(boxes.min()) >= 0.0 and float(boxes.max()) <= 1.0


def test_init_vit_shapes_match_reference():
    jparams = jvit.init_vit(jax.random.PRNGKey(0), SHORT)
    tparams = tvit.init_vit(_tcfg(SHORT), device="cpu")
    jflat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    assert len(jflat) == 7 + 10 * SHORT.layers
    for path, leaf in jflat:
        node = tparams
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape and node.dtype == torch.float32, path


def test_converter_refuses_a_foreign_tree():
    jparams = _np_tree(jvit.init_vit(jax.random.PRNGKey(0), SHORT))
    with pytest.raises(ValueError, match="shape"):
        from_numpy_vit_params(jparams, dataclasses.replace(_tcfg(SHORT), hidden=64),
                              device="cpu")
    del jparams["box_head"]
    with pytest.raises(ValueError, match="keys"):
        from_numpy_vit_params(jparams, _tcfg(SHORT), device="cpu")


def test_entry_points_without_device_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="init_vit runs on CUDA"):
        tvit.init_vit(_tcfg(SHORT))
    with pytest.raises(RuntimeError, match="from_numpy_vit_params runs on CUDA"):
        from_numpy_vit_params(_np_tree(jvit.init_vit(jax.random.PRNGKey(0), SHORT)),
                              _tcfg(SHORT))
