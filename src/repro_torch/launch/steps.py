"""Step functions: train / prefill / decode (port of
``repro.launch.steps``).

``build_train_step`` runs the model's ``loss_fn`` forward and backward
with torch autograd, an optional error-feedback int8 compression of the
gradients, and AdamW under the warm-up cosine schedule.  With ``mesh=``
(a :class:`~repro_torch.shard.dist.DistMesh` with ``("data", "model")``
axes) every process runs it on its blocks of the train state
(``train_state_shardings``) and its rows of the batch
(``data.shard_batch(mesh=)``): the model gathers each layer's parameters
where it uses them, each process's loss is its share of the global loss,
the collectives' transposes and a sum over each leaf's replicated axes
make every gradient block that of the global loss, and AdamW updates the
blocks (``models.sharding_ctx``).  The reported loss is the rank-ordered
sum of the shares, the same bits on every process.
"""
from __future__ import annotations

import torch

from repro_torch.models import Model, param_shapes
from repro_torch.models.sharding_ctx import P, sharding_context
from repro_torch.optim import adamw_update, compress_grads, warmup_cosine
from repro_torch.optim.tree import tree_flatten, tree_map

from .mesh import Sharding, sanitize_shardings


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


def train_state_shardings(model: Model, mesh, params_like, opt_like):
    """The parameters' and the AdamW state's :class:`Sharding` trees: the
    model's specs sanitized against the whole shapes (``params_like``,
    ``opt_like``: tensors, ``meta`` ones will do)."""
    pspecs = model.specs()
    p_sh = sanitize_shardings(pspecs, params_like, mesh)
    o_sh = type(opt_like)(
        step=Sharding(mesh, P()),
        m=sanitize_shardings(pspecs, opt_like.m, mesh),
        v=sanitize_shardings(pspecs, opt_like.v, mesh))
    return p_sh, o_sh


def cache_shardings(model: Model, mesh, cache_like):
    """The cache's :class:`Sharding` tree (batch over data, sequence over
    model): the layout only; nothing runs on it in the port yet."""
    return sanitize_shardings(model.cache_specs(), cache_like, mesh)


def mesh_param_shardings(model: Model, mesh):
    """The parameters' shardings on ``mesh``, from their shapes alone."""
    shapes = param_shapes(model)
    return sanitize_shardings(model.specs(), shapes, mesh)


def _sum_replicas(g: torch.Tensor, sh: Sharding) -> torch.Tensor:
    """A gradient block summed over the mesh axes its leaf is replicated
    on, in rank order."""
    for a in sh.mesh.axis_names:
        if a not in sh.axes:
            g = sh.mesh.group(a).psum(g)
    return g


def build_train_step(model: Model, *, peak_lr: float = 3e-4,
                     warmup_steps: int = 100, total_steps: int = 10_000,
                     weight_decay: float = 0.1, compress: bool = False,
                     mesh=None):
    """``train_step(params, opt, batch[, comp_state])`` -> ``(params, opt[,
    comp_state], {"loss", "lr"})``; new tensors, the inputs untouched.
    With ``mesh`` the tensors are this process's blocks and ``batch`` its
    rows (module docstring)."""
    p_sh = None if mesh is None else mesh_param_shardings(model, mesh)

    def grads_of(params, batch):
        if mesh is None:
            return value_and_grad(model.loss_fn, params, batch)
        rows = batch.shardings["tokens"].axes
        with sharding_context(mesh, full_batch=True, params=p_sh,
                              batch=rows):
            share, grads = value_and_grad(model.loss_fn, params, batch)
        grads = tree_map(_sum_replicas, grads, p_sh)
        return mesh.group().psum(share), grads

    def train_step(params, opt, batch, comp_state=None):
        loss, grads = grads_of(params, batch)
        if compress:
            grads, comp_state = compress_grads(grads, comp_state, p_sh)
        lr = warmup_cosine(opt.step, peak_lr=peak_lr,
                           warmup_steps=warmup_steps,
                           total_steps=total_steps)
        params, opt = adamw_update(grads, opt, params, lr=lr,
                                   weight_decay=weight_decay,
                                   shardings=p_sh)
        metrics = {"loss": loss, "lr": lr}
        if compress:
            return params, opt, comp_state, metrics
        return params, opt, metrics

    return train_step


def local_state(tree, shardings):
    """This process's blocks of a whole train-state tree, each a tensor of
    its own."""
    return tree_map(lambda t, sh: sh.local(t).clone(), tree, shardings)


def gather_state(tree, shardings):
    """The whole tensors of a tree of blocks, on every process."""
    return tree_map(lambda t, sh: sh.gather(t), tree, shardings)


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
