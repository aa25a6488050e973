"""The port's checkpoints (nos_tpu_torch/models/checkpoint.py) on the four
scenarios of tests/test_checkpoint.py, on CPU meshes (`["cpu"] * n`).

A round trip is bit-exact (bfloat16 included); training resumed from a
checkpoint gives the same losses and params, bit for bit, as training that
was never interrupted; a restore onto a dp 2 x tp 2 mesh places each leaf
(and each AdamW moment) by its rule."""

import numpy as np
import pytest
import torch

from nos_tpu_torch.models.checkpoint import latest_step, restore_checkpoint, save_checkpoint
from nos_tpu_torch.models.gpt import GPTConfig
from nos_tpu_torch.models.train import (TrainConfig, _leaves, init_train_state,
                                        make_train_step, synthetic_batch)
from nos_tpu_torch.parallel import (MeshTree, build_mesh, shard_tensor,
                                    transformer_param_rules, spec_for_path)
from nos_tpu_torch.parallel.sharding import tree_leaves

CFG = TrainConfig(model=GPTConfig(vocab=64, hidden=32, layers=1, heads=2, max_seq=8,
                                  dtype="float32"))


def _mesh(axes):
    return build_mesh(axes, devices=["cpu"] * 4)


def _tokens(seed, batch=4, seq=8):
    return synthetic_batch(torch.Generator().manual_seed(seed), CFG.model, batch, seq, "cpu")


def _state(mesh, seed=0, cfg=CFG):
    if mesh is None:
        return init_train_state(cfg, torch.Generator().manual_seed(seed), device="cpu")
    return init_train_state(cfg, torch.Generator().manual_seed(seed), mesh=mesh)


def _equal_leaves(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.device == y.device and torch.equal(x, y)


def test_roundtrip_preserves_state_and_training_continues(tmp_path):
    mesh = _mesh({"dp": 2, "tp": 2})
    params, opt = _state(mesh)
    step_fn = make_train_step(CFG, mesh)
    tokens = _tokens(1)
    params, opt, _ = step_fn(params, opt, tokens)

    path = save_checkpoint(str(tmp_path), 1, params, opt)
    assert path.endswith("step_1") and latest_step(str(tmp_path)) == 1

    # "New process": a fresh init gives the structure; restore over it.
    fresh = _state(mesh, seed=42)
    r_params, r_opt, step = restore_checkpoint(str(tmp_path), None, like=fresh, mesh=mesh)
    assert step == 1
    _equal_leaves(params, r_params)
    for a, b in zip(_leaves(params), _leaves(r_params)):
        sa, sb = opt.state[a], r_opt.state[b]
        assert torch.equal(sa["step"], sb["step"])
        assert torch.equal(sa["exp_avg"], sb["exp_avg"])
        assert torch.equal(sa["exp_avg_sq"], sb["exp_avg_sq"])

    # Training continues identically from the restored state.
    p1, o1, m1 = step_fn(params, opt, tokens)
    p2, o2, m2 = step_fn(r_params, r_opt, tokens)
    assert m1["loss"].item() == m2["loss"].item()
    _equal_leaves(p1, p2)


def test_restore_onto_a_mesh_places_each_leaf_by_its_rule(tmp_path):
    """Saved from one device, restored onto dp 2 x tp 2: every position's
    block of every leaf and moment is the rule's block of the global one."""
    params, opt = _state(None)
    params, opt, _ = make_train_step(CFG)(params, opt, _tokens(1))
    save_checkpoint(str(tmp_path), 5, params, opt)
    mesh = _mesh({"dp": 2, "tp": 2})
    r_params, r_opt, _ = restore_checkpoint(str(tmp_path), 5, like=_state(mesh, 7), mesh=mesh)
    assert isinstance(r_params, MeshTree)
    rules = transformer_param_rules()
    sharded = 0
    for path, leaf in tree_leaves(params):
        spec = r_params.specs
        for key in path.split("/"):
            spec = spec[key]
        assert spec == spec_for_path(path, rules)  # every dim divides here
        sharded += spec != ()
        for name, want in (("param", leaf.detach()), ("exp_avg", opt.state[leaf]["exp_avg"]),
                           ("exp_avg_sq", opt.state[leaf]["exp_avg_sq"])):
            blocks = shard_tensor(want, mesh, spec)
            for p, got in enumerate(r_params.leaves(path)):
                value = got if name == "param" else r_opt.state[got][name]
                assert value.is_contiguous() and torch.equal(value, blocks[p]), (path, name, p)
    assert sharded == 9  # tok_emb, lm_head and 7 projections


def test_resumed_training_equals_uninterrupted(tmp_path):
    """Three steps straight against one step, a checkpoint, a restore into
    a fresh job and two more steps: the same losses and params, bit for
    bit, on one device and on a dp 2 x tp 2 mesh."""
    batches = [_tokens(s) for s in (11, 12, 13)]
    for mesh in (None, _mesh({"dp": 2, "tp": 2})):
        step_fn = make_train_step(CFG, mesh)
        params, opt = _state(mesh)
        straight = []
        for b in batches:
            params, opt, m = step_fn(params, opt, b)
            straight.append(m["loss"].item())
        p2, o2 = _state(mesh)
        p2, o2, m = step_fn(p2, o2, batches[0])
        resumed = [m["loss"].item()]
        directory = tmp_path / ("mesh" if mesh else "single")
        save_checkpoint(str(directory), 1, p2, o2)
        p2, o2, _ = restore_checkpoint(str(directory), 1, like=_state(mesh, 3), mesh=mesh)
        for b in batches[1:]:
            p2, o2, m = step_fn(p2, o2, b)
            resumed.append(m["loss"].item())
        assert resumed == straight
        _equal_leaves(params, p2)


def test_latest_step_picks_max(tmp_path):
    mesh = _mesh({"dp": 4})
    params, opt = _state(mesh)
    save_checkpoint(str(tmp_path), 3, params, opt)
    save_checkpoint(str(tmp_path), 10, params, opt)
    (tmp_path / "not_a_step").mkdir()
    assert latest_step(str(tmp_path)) == 10
    _, _, step = restore_checkpoint(str(tmp_path), None, like=(params, opt))
    assert step == 10
    assert latest_step(str(tmp_path / "missing")) is None


def test_restore_missing_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path), None, like=({}, None))


def test_roundtrip_is_bit_exact_in_bfloat16(tmp_path):
    """bf16 params and moments (values a float32 round trip would not
    keep apart) come back bit for bit, in bf16."""
    cfg = TrainConfig(model=GPTConfig(vocab=64, hidden=32, layers=1, heads=2, max_seq=8))
    params, opt = _state(None, cfg=cfg)
    params, opt, _ = make_train_step(cfg)(params, opt, _tokens(2))
    leaf = params["layers"]["0"]["wq"]
    with torch.no_grad():
        leaf[0, 0] = 1.5
        leaf[0, 1] = torch.tensor(1.0 + 2.0 ** -7, dtype=torch.bfloat16)
    save_checkpoint(str(tmp_path), 2, params, opt)
    rp, ro, step = restore_checkpoint(str(tmp_path), None, like=_state(None, 9, cfg))
    assert step == 2
    _equal_leaves(params, rp)
    assert rp["layers"]["0"]["wq"].dtype == torch.bfloat16
    assert rp["layers"]["0"]["wq"][0, :2].float().tolist() == [1.5, 1.0 + 2.0 ** -7]
    for a, b in zip(_leaves(params), _leaves(rp)):
        assert ro.state[b]["exp_avg"].dtype == torch.bfloat16
        assert torch.equal(opt.state[a]["exp_avg_sq"], ro.state[b]["exp_avg_sq"])
    assert np.isfinite(make_train_step(cfg)(rp, ro, _tokens(3))[2]["loss"].item())


def test_restore_refuses_another_tree(tmp_path):
    params, opt = _state(None)
    save_checkpoint(str(tmp_path), 1, params, opt)
    other = TrainConfig(model=GPTConfig(vocab=64, hidden=32, layers=2, heads=2, max_seq=8,
                                        dtype="float32"))
    with pytest.raises(ValueError, match="leaves"):
        restore_checkpoint(str(tmp_path), 1, like=_state(None, cfg=other))
