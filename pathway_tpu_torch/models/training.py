"""Training step for the transformer stack (counterpart of
pathway_tpu/models/training.py).

Fine-tuning the embedder / reranker / decoder in-framework: a
cross-entropy step over the functional `forward` and a parameter tree, as
in the JAX package, differentiated by autograd (flash attention's
gradient is its plain version's, recomputed, as the JAX package's
custom_vjp does). The sharded step lays the batch over the mesh's 'dp'
axis and the parameters Megatron-style over 'tp'
(models/transformer.param_sharding_rules), and runs every position from
this one process (parallel/mesh.py): `tp_forward` for each dp row, the
global masked mean of the loss, taken vocab-parallel, and one backward
through the collectives.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from pathway_tpu_torch.models.transformer import (
    TransformerConfig,
    _leaves,
    _rebuild,
    _to_device_ints,
    _tree_to,
    forward,
    tp_forward,
    tp_split,
)
from pathway_tpu_torch.parallel.collectives import all_gather, psum


def _loss_terms(logits, mask, labels):
    """(-sum of the masked label log-probabilities, the mask's sum), in f32."""
    logits = logits.float()
    top = logits.amax(dim=-1, keepdim=True)
    logp = logits - torch.log(torch.exp(logits - top).sum(dim=-1, keepdim=True)) - top
    picked = torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    m = mask.float()
    return -(picked * m).sum(), m.sum()


def _vocab_parallel_loss_terms(logits: list, mask, labels):
    """`_loss_terms` of logits split by vocab over a tp axis, one [B, L, V/tp]
    slice per position, as Megatron computes it: each position's
    log-sum-exp over its slice, all-gathered ([B, L, tp]) and combined,
    and the label's logit psummed from the one position whose slice holds
    it. Only [B, L]-sized values cross positions; the result is on the
    first position's device."""
    rows = logits[0].shape[-1]
    lse, picked = [], []
    for t, lt in enumerate(logits):
        lt = lt.float()
        local = labels.to(lt.device).long() - t * rows
        hit = (local >= 0) & (local < rows)
        lse.append(torch.logsumexp(lt, dim=-1, keepdim=True))
        picked.append(torch.gather(lt, -1, local.clamp(0, rows - 1)[..., None])[..., 0] * hit)
    logp = psum(picked)[0] - torch.logsumexp(all_gather(lse, axis=-1)[0], dim=-1)
    m = mask.to(logp.device).float()
    return -(logp * m).sum(), m.sum()


def loss_fn(params, config: TransformerConfig, ids, mask, labels, *,
            use_flash: Optional[bool] = None):
    """Cross-entropy LM loss (causal) or masked-token loss (encoder): the
    mean over mask's valid positions of -log p(label)."""
    device = params["embed"].device
    ids, mask, labels = (_to_device_ints(a, device) for a in (ids, mask, labels))
    logits = forward(params, config, ids, mask, return_hidden=True, use_flash=use_flash)
    num, den = _loss_terms(logits, mask, labels)
    return num / (den + 1e-9)


def loss_and_grads(params, config: TransformerConfig, ids, mask, labels, *,
                   use_flash: Optional[bool] = None):
    """(loss, the gradient tree of the loss over `params`), as JAX's
    `value_and_grad(loss_fn)`."""
    inputs = [p.detach().requires_grad_() for p in _leaves(params)]
    loss = loss_fn(_rebuild(params, iter(inputs)), config, ids, mask, labels, use_flash=use_flash)
    grads = torch.autograd.grad(loss, inputs)
    return loss.detach(), _rebuild(params, iter(grads))


def sgd_step(params, grads, lr: float):
    """p -= lr * g for every leaf, in place; returns `params`."""
    with torch.no_grad():
        for p, g in zip(_leaves(params), _leaves(grads), strict=True):
            p.sub_(lr * g)
    return params


def make_train_step(config: TransformerConfig, lr: float = 1e-3):
    """step(params, ids, mask, labels) -> (new_params, loss): one SGD step.
    The new params are `params`, updated in place."""

    def step(params, ids, mask, labels):
        loss, grads = loss_and_grads(params, config, ids, mask, labels)
        return sgd_step(params, grads, lr), loss

    return step


def _device(mesh, **position):
    """The mesh's device at `position`, ignoring axes the mesh lacks
    (a mesh without 'tp' is tp = 1)."""
    return mesh.device(**{k: v for k, v in position.items() if k in mesh.axis_names})


def sharded_loss_and_grads(mesh, config: TransformerConfig, shards: list, ids, mask, labels):
    """(loss, gradients) of the global masked mean loss over the mesh.

    shards: `place_params`' per-tp-position trees (a replicated leaf is one
    tensor, shared by every tree, on the mesh's first device; tp shard t on
    the device at dp 0, tp t). ids, mask, labels: `place_batch`'s lists of
    dp row blocks. Each dp row broadcasts the leaves to its own devices
    (differentiably, so their gradients add up in the one master: the dp
    all-reduce) and runs `tp_forward`, whose vocab-sharded logits give the
    loss terms vocab-parallel; the loss's numerator and denominator are
    psummed over dp. Returns the loss on the mesh's first device and
    one gradient tree per tp position, a replicated leaf's gradient shared
    as its leaf is."""
    masters = list({id(p): p for tree in shards for p in _leaves(tree)}.values())
    inputs = {id(p): p.detach().requires_grad_() for p in masters}
    trees = [_rebuild(tree, (inputs[id(p)] for p in _leaves(tree))) for tree in shards]
    num, den = [], []
    for d in range(mesh.shape.get("dp", 1)):
        local = [_tree_to(tree, _device(mesh, dp=d, tp=t)) for t, tree in enumerate(trees)]
        n, m = _vocab_parallel_loss_terms(tp_forward(local, config, ids[d], mask[d]),
                                          mask[d], labels[d])
        num.append(n)
        den.append(m)
    loss = psum(num)[0] / (psum(den)[0] + 1e-9)
    grads = dict(zip(inputs, torch.autograd.grad(loss, list(inputs.values()))))
    return loss.detach(), [_rebuild(tree, (grads[id(p)] for p in _leaves(tree))) for tree in shards]


def make_sharded_train_step(mesh, config: TransformerConfig, lr: float = 1e-3):
    """The train step over a ("dp", "tp") mesh: inputs batch-sharded on
    'dp', params sharded per param_sharding_rules on 'tp', the loss on the
    mesh's first device. Returns (step, place_params, place_batch):

    - place_params(params) -> one tree per tp position: each leaf split by
      its rule and copied to its device (the caller's tree is left as it
      is); a replicated leaf is one master on the mesh's first device;
    - place_batch(*arrays) -> for each [B, ...] array, its B rows split
      into dp blocks, block d on the device at dp d;
    - step(shards, ids, mask, labels) -> (new shards, loss): one SGD step,
      the shards updated in place. `models.transformer.tp_gather` gives
      the full tree back."""
    dp, tp = mesh.shape.get("dp", 1), mesh.shape.get("tp", 1)
    if config.heads % tp:
        raise ValueError(f"heads {config.heads} not divisible by the tp axis of size {tp}")

    def place_params(params) -> list:
        masters: Dict[int, Any] = {}

        def put(leaf, device):
            if id(leaf) not in masters:
                masters[id(leaf)] = leaf.detach().to(device, copy=True)
            return masters[id(leaf)]

        return [
            _rebuild(tree, (put(p, _device(mesh, tp=t)) for p in _leaves(tree)))
            for t, tree in enumerate(tp_split(params, config, mesh))
        ]

    def place_batch(*arrays) -> tuple:
        out = []
        for a in arrays:
            a = a if torch.is_tensor(a) else torch.from_numpy(np.asarray(a))
            if a.shape[0] % dp:
                raise ValueError(f"batch of {a.shape[0]} rows does not split over dp={dp}")
            out.append([block.to(_device(mesh, dp=d)) for d, block in enumerate(a.chunk(dp, 0))])
        return tuple(out)

    def step(shards, ids, mask, labels):
        loss, grads = sharded_loss_and_grads(mesh, config, shards, ids, mask, labels)
        seen = set()
        with torch.no_grad():
            for tree, grad_tree in zip(shards, grads):
                for p, g in zip(_leaves(tree), _leaves(grad_tree)):
                    if id(p) not in seen:  # a replicated master is in every tree
                        seen.add(id(p))
                        p.sub_(lr * g)
        return shards, loss

    return step, place_params, place_batch
