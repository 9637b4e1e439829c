"""Step functions: train / prefill / decode (port of
``repro.launch.steps``).

``build_train_step`` runs the model's ``loss_fn`` forward and backward
with torch autograd, an optional error-feedback int8 compression of the
gradients, and AdamW under the warm-up cosine schedule.  The reference's
``train_state_shardings`` and ``cache_shardings`` wait for LM sharding
(ROADMAP.md, queue 1, slice 4).
"""
from __future__ import annotations

import torch

from repro_torch.models import Model
from repro_torch.optim import adamw_update, compress_grads, warmup_cosine
from repro_torch.optim.tree import tree_flatten


def value_and_grad(loss_fn, params, *args):
    """``(loss, grads)`` of ``loss_fn(params, *args)``, the gradients a tree
    like ``params``'s (``jax.value_and_grad``); ``params`` are not
    modified."""
    leaves, unflatten = tree_flatten(params)
    leaves = [p.detach().requires_grad_() for p in leaves]
    with torch.enable_grad():
        loss = loss_fn(unflatten(leaves), *args)
        grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), unflatten(list(grads))


def build_train_step(model: Model, *, peak_lr: float = 3e-4,
                     warmup_steps: int = 100, total_steps: int = 10_000,
                     weight_decay: float = 0.1, compress: bool = False):
    """``train_step(params, opt, batch[, comp_state])`` -> ``(params, opt[,
    comp_state], {"loss", "lr"})``; new tensors, the inputs untouched."""
    def train_step(params, opt, batch, comp_state=None):
        loss, grads = value_and_grad(model.loss_fn, params, batch)
        if compress:
            grads, comp_state = compress_grads(grads, comp_state)
        lr = warmup_cosine(opt.step, peak_lr=peak_lr,
                           warmup_steps=warmup_steps,
                           total_steps=total_steps)
        params, opt = adamw_update(grads, opt, params, lr=lr,
                                   weight_decay=weight_decay)
        metrics = {"loss": loss, "lr": lr}
        if compress:
            return params, opt, comp_state, metrics
        return params, opt, metrics

    return train_step


def build_prefill_step(model: Model):
    @torch.no_grad()
    def prefill_step(params, cache, batch):
        kw = {k: batch[k] for k in ("positions", "frames") if k in batch}
        return model.prefill(params, batch["tokens"], cache, **kw)

    return prefill_step


def build_decode_step(model: Model):
    @torch.no_grad()
    def decode_step(params, cache, batch):
        kw = {k: batch[k] for k in ("positions",) if k in batch}
        return model.decode_step(params, batch["tokens"], cache, **kw)

    return decode_step
