"""Single-device training step.

Port of `nos_tpu/models/train.py`: `TrainConfig` (:26), `make_optimizer`
(:37), `init_train_state` (:44), `make_train_step` (:53) and
`synthetic_batch` (:78), for one device. optax's
`chain(clip_by_global_norm, adamw)` becomes optax's clip formula written
out, then `torch.optim.AdamW` with optax's defaults (betas 0.9/0.999, eps
1e-8, every leaf decayed, moments in the param dtype). torch applies the
decoupled decay before the Adam step where optax adds it to the update:
the same update, rounded at another place. The step updates params and
moments in place, where JAX returns new trees, and never waits on the
device. Sharded training over a mesh is a later slice (ROADMAP A6/A9).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple

import torch

from nos_tpu_torch.device import resolve
from nos_tpu_torch.models.gpt import GPTConfig, gpt_loss, init_gpt


@dataclass(frozen=True)
class TrainConfig:
    model: GPTConfig = GPTConfig()
    learning_rate: float = 3e-4
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    # Sequence chunk of the vocabulary-projection loss (see gpt_loss).
    loss_chunk: int = 256


def named_leaves(tree: Dict, prefix: str = "") -> Iterator[Tuple[str, torch.Tensor]]:
    """(path, tensor) for each leaf of a nested param dict, in insertion
    order; paths join the keys with "/"."""
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from named_leaves(val, f"{prefix}{key}/")
        else:
            yield prefix + key, val


def _leaves(tree: Dict) -> List[torch.Tensor]:
    return [t for _, t in named_leaves(tree)]


def make_optimizer(cfg: TrainConfig, params: Dict) -> torch.optim.AdamW:
    """optax.adamw(lr, weight_decay) over every leaf of `params` (which
    become leaves that require grad). The global-norm clip is applied by
    the step (`_clip_by_global_norm`)."""
    leaves = [p.requires_grad_(True) for p in _leaves(params)]
    return torch.optim.AdamW(leaves, lr=cfg.learning_rate, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=cfg.weight_decay)


def init_train_state(cfg: TrainConfig, generator: Optional[torch.Generator] = None,
                     device=None):
    """Params (`init_gpt`) on `device` (None: CUDA) + their optimizer."""
    device = resolve(device, "init_train_state")
    params = init_gpt(cfg.model, generator, device=device)
    return params, make_optimizer(cfg, params)


def _clip_by_global_norm(grads: List[torch.Tensor], max_norm: float) -> None:
    """optax.clip_by_global_norm in place: g if norm < max_norm else
    g / norm * max_norm, the norm over every leaf (summed in f32 here) and
    cast to each leaf's dtype as optax casts it. No host sync: the branch is
    a select on the device."""
    norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g, dtype=torch.float32) for g in grads]))
    keep = norm < max_norm
    div = torch.where(keep, torch.ones_like(norm), norm)
    mul = torch.where(keep, torch.ones_like(norm), torch.full_like(norm, max_norm))
    for g in grads:
        g.div_(div.to(g.dtype)).mul_(mul.to(g.dtype))


def make_train_step(cfg: TrainConfig, mesh=None):
    """The train step: step(params, opt_state, tokens) -> (params,
    opt_state, {"loss": loss}), with `opt_state` the optimizer of
    `make_optimizer`/`init_train_state`. Params and moments are updated in
    place; the returned loss is a device scalar."""
    if mesh is not None:
        raise NotImplementedError(
            "the sharded train step is not ported yet: ROADMAP A6 (tensor "
            "parallelism) and A9 (sharded training)"
        )

    def step(params, opt_state, tokens):
        leaves = _leaves(params)
        opt_state.zero_grad(set_to_none=True)
        loss = gpt_loss(params, tokens, cfg.model, loss_chunk=cfg.loss_chunk)
        loss.backward()
        _clip_by_global_norm([p.grad for p in leaves], cfg.grad_clip)
        opt_state.step()
        return params, opt_state, {"loss": loss.detach()}

    return step


def synthetic_batch(generator: torch.Generator, cfg: GPTConfig, batch: int, seq: int,
                    device=None) -> torch.Tensor:
    """[batch, seq] int32 tokens uniform in [0, vocab), drawn on the CPU
    from `generator` (not JAX's RNG), on `device` (None: CUDA)."""
    device = resolve(device, "synthetic_batch")
    toks = torch.randint(0, cfg.vocab, (batch, seq), generator=generator, dtype=torch.int32)
    return toks.to(device)
