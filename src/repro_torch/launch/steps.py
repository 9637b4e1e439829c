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

``build_prefill_step`` / ``build_decode_step`` with ``mesh=`` serve
every family in the reference's layout (the dry run's prefill and decode
cells): parameters in blocks, the cache's batch over ``data``
(``local_cache``) and, over ``model``, a K/V cache's sequence (the
transformer's, the hybrid's shared block's, the encoder-decoder's self-
and cross-attention's) and an SSM state's channels (``conv``) and heads
(``ssd``), the batch rows over the data axes.  The ``model`` axis splits
only the cache: each process computes every head of its rows on the
gathered parameters, gathers a layer's SSM state where it runs and keeps
its own block of the new one.
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
    model), sanitized against the whole cache ``cache_like`` (``meta``
    tensors will do): the layout ``local_cache`` builds and the mesh's
    prefill and decode steps serve from."""
    return sanitize_shardings(model.cache_specs(), cache_like, mesh)


class LocalCache(dict):
    """This process's block of a serving cache; ``shardings`` holds the
    whole cache's :class:`Sharding` tree."""

    def __init__(self, tree: dict, shardings):
        super().__init__(tree)
        self.shardings = shardings


def local_cache(model: Model, mesh, batch_size: int, max_len: int,
                dtype=torch.bfloat16) -> LocalCache:
    """This process's block of an empty cache of ``batch_size`` rows and
    ``max_len`` positions on ``mesh``'s device (a transformer's K/V:
    ``[L, batch_size / data, KV, max_len / model, D]``, the whole sequence
    where ``model`` does not divide ``max_len``; an SSM's ``conv`` [L,
    batch_size / data, K-1, C / model] and ``ssd`` [L, batch_size / data,
    H / model, Pd, N]); the fill ``idx`` and an absent hybrid ``tail``
    (``None``) as they are."""
    like = model.init_cache(batch_size, max_len, dtype=dtype, device="meta")
    sh = cache_shardings(model, mesh, like)
    return LocalCache(tree_map(
        lambda t, s: torch.zeros(s.local_shape(tuple(t.shape)),
                                 dtype=t.dtype, device=mesh.device)
        if isinstance(t, torch.Tensor) else t, like, sh), sh)


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


def _serving(model: Model, mesh, fn, keys):
    """``fn(params, tokens, cache, **kw)`` as a step ``(params, cache,
    batch)``, under ``torch.no_grad``; with ``mesh``, on this process's
    blocks (module docstring of ``build_prefill_step``)."""
    p_sh = None if mesh is None else mesh_param_shardings(model, mesh)

    @torch.no_grad()
    def step(params, cache, batch):
        kw = {k: batch[k] for k in keys if k in batch}
        if mesh is None:
            return fn(params, batch["tokens"], cache, **kw)
        if not isinstance(cache, LocalCache):
            raise TypeError("a mesh step serves from local_cache()'s block")
        with sharding_context(mesh, full_batch=False, params=p_sh,
                              batch=batch.shardings["tokens"].axes,
                              cache=model.cache_roles(cache.shardings)):
            logits, new = fn(params, batch["tokens"], cache, **kw)
        return logits, LocalCache(new, cache.shardings)

    return step


def build_prefill_step(model: Model, mesh=None):
    """``prefill_step(params, cache, batch)`` -> ``(last-token logits,
    cache)``.  With ``mesh`` (a ``("data", "model")`` mesh of processes;
    every family), the reference's serving layout: ``params``
    this process's blocks (``local_state`` with ``mesh_param_shardings``),
    ``cache`` its block (``local_cache``: batch over data, a K/V cache's
    sequence and an SSM state's channels and heads over model) and
    ``batch`` its rows (``shard_batch(mesh=,
    full_batch=False)``); the logits are its batch rows, the same bits on
    every ``model`` rank of a data row."""
    return _serving(model, mesh, model.prefill, ("positions", "frames"))


def build_decode_step(model: Model, mesh=None):
    """``decode_step(params, cache, batch)`` -> ``(logits, cache)``: one
    token; ``mesh`` as ``build_prefill_step``'s."""
    return _serving(model, mesh, model.decode_step, ("positions",))
