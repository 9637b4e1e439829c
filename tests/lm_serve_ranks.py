"""Rank bodies for ``tests/test_torch_lm_serve_shard.py``.

Each function here runs once in every process of
``repro_torch.shard.spawn`` (four gloo ranks on the CPU, laid out on a
``("data", "model") = (2, 2)`` mesh) as ``fn(mesh, *args)``; spawn pickles
them by name, so they live at module level, in a module that imports
neither JAX nor the reference package.  Inputs are numpy arrays the test
made (the reference's initial parameters and tokens among them); each
returns plain values and numpy arrays, compared in the test process.
"""
import contextlib
import dataclasses

import numpy as np
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.data import shard_batch
from repro_torch.kernels import ops as kops
from repro_torch.launch import dryrun, mesh as meshlib, steps
from repro_torch.models import get_model, moe
from repro_torch.models.convert import params_from_jax

SHAPE = (2, 2)


def _mesh(mesh):
    return meshlib.make_production_mesh(mesh, shape=SHAPE)


def config(arch: str, capacity=None, attn_impl="flash"):
    """The reduced config (float32), its MoE at ``capacity``; attention
    through ``attn_impl``."""
    cfg = dataclasses.replace(reduced(get_config(arch)), attn_impl=attn_impl)
    if capacity is not None:
        cfg = dataclasses.replace(cfg, capacity_factor=capacity)
    return cfg


@contextlib.contextmanager
def flash_calls():
    """Count the calls of ``kops.flash_attention`` the model makes (on the
    CPU the wrapper runs its plain version and counts no launch)."""
    real, calls = kops.flash_attention, []

    def counted(*a, **kw):
        calls.append(a[1].shape[2])     # the keys' length
        return real(*a, **kw)
    kops.flash_attention = counted
    try:
        yield calls
    finally:
        kops.flash_attention = real


def _batch(tokens, positions, mesh):
    b = {"tokens": tokens}
    if positions is not None:
        b["positions"] = positions
    return shard_batch(b, mesh=mesh, full_batch=False)


def serve_case(mesh, case, p0_np, feed):
    """One serving run on the mesh from the reference's parameters:
    ``feed`` is the list of ``(tokens, positions or None)`` steps the
    reference ran (the prompt, a continuation, then one token a decode
    step).  Returns this process's logits of every step, its cache block,
    the cache's specs, the flash calls of every step and the MoE's dropped
    pairs."""
    _mesh(mesh)
    arch, capacity, impl, batch, max_len = (case[k] for k in (
        "arch", "capacity", "impl", "batch", "max_len"))
    cfg = config(arch, capacity, impl)
    model = get_model(cfg)
    params = steps.local_state(params_from_jax(p0_np, device="cpu"),
                               steps.mesh_param_shardings(model, mesh))
    cache = steps.local_cache(model, mesh, batch, max_len,
                              dtype=torch.float32)
    prefill = steps.build_prefill_step(model, mesh=mesh)
    decode = steps.build_decode_step(model, mesh=mesh)
    logits, flash = [], []
    with moe.drop_tally() as drops:
        for tokens, positions in feed:
            step = decode if tokens.shape[1] == 1 else prefill
            with flash_calls() as calls:
                out, cache = step(params, cache,
                                  _batch(tokens, positions, mesh))
            logits.append(out.numpy())
            flash.append(calls)
    return {"coords": mesh.coords, "logits": logits, "flash": flash,
            "drops": int(sum(drops)),
            "k": cache["k"].numpy(), "v": cache["v"].numpy(),
            "idx": cache["idx"],
            "spec": tuple(cache.shardings["k"].spec)}


def vocab_case(mesh, table_np, head_np, tokens_np, h_np):
    """The embedding lookup and the head's logits on this process's
    vocabulary blocks (no autograd: serving) and through the whole
    gathered parameters (autograd on: training's path), with the bytes
    each counted."""
    from repro_torch.models import layers as L
    from repro_torch.models import sharding_ctx as sc

    tree = {"embed": torch.from_numpy(table_np),
            "lm_head": torch.from_numpy(head_np)}
    specs = {"embed": L.embed_specs(None), "lm_head": L.unembed_specs(None)}
    sh = meshlib.sanitize_shardings(specs, tree, mesh)
    table, head = (sh[k].local(tree[k]).clone() for k in ("embed",
                                                          "lm_head"))
    tokens, h = torch.from_numpy(tokens_np), torch.from_numpy(h_np)
    out, tally = {}, mesh.group()
    with sc.sharding_context(mesh, params=sh, batch=("data",)):
        for name, grad in (("local", False), ("gathered", True)):
            before = dict(tally.bytes)
            with torch.set_grad_enabled(grad):
                rows = L.embed(table, tokens)
                logits = L.unembed_logits(head, h)
            out[name] = {"rows": rows.detach().numpy(),
                         "logits": logits.detach().numpy(),
                         "bytes": {k: v - before.get(k, 0)
                                   for k, v in tally.bytes.items()
                                   if v > before.get(k, 0)}}
    return out


def serve_all(mesh, cases, p0s, feeds, batch_np, cells, vocab):
    """Every serving case, the batch rows in serving's layout, the
    vocabulary-local lookup and head, and the dry run's live serving
    cells, in one spawn."""
    _mesh(mesh)
    out = {"cases": [serve_case(mesh, c, p0s[c["ref"]], feeds[c["ref"]])
                     for c in cases]}
    lb = shard_batch(batch_np, mesh=mesh, full_batch=False)
    out["rows"] = {k: v.numpy() for k, v in lb.items()}
    out["row_specs"] = {k: tuple(v.spec) for k, v in lb.shardings.items()}
    out["coords"] = mesh.coords
    out["vocab"] = vocab_case(mesh, *vocab)
    out["dryrun"] = {}
    for arch, shape, seq in cells:
        out["dryrun"][(arch, shape)] = dryrun.run_cell(
            arch, shape, mesh, cfg=config(arch), seq=seq, out_dir=None)
    return out


def one_process(case, p0_np, feed):
    """The same run through one process's steps (no mesh), in the test's
    process: every step's logits and the whole cache."""
    cfg = config(case["arch"], case["capacity"], case["impl"])
    model = get_model(cfg)
    params = params_from_jax(p0_np, device="cpu")
    cache = model.init_cache(case["batch"], case["max_len"],
                             dtype=torch.float32, device="cpu")
    prefill = steps.build_prefill_step(model)
    decode = steps.build_decode_step(model)
    logits = []
    for tokens, positions in feed:
        b = {"tokens": torch.from_numpy(tokens)}
        if positions is not None:
            b["positions"] = torch.from_numpy(positions)
        step = decode if tokens.shape[1] == 1 else prefill
        out, cache = step(params, cache, b)
        logits.append(out.numpy())
    return logits, cache["k"].numpy(), cache["v"].numpy()


def block_of(whole: np.ndarray, coords: dict, spec) -> np.ndarray:
    """A rank's block of a whole cache [L, B, KV, S, D] under ``spec``."""
    rows = whole.shape[1] // SHAPE[0]
    d = coords["data"]
    out = whole[:, d * rows:(d + 1) * rows]
    if spec[3] is not None:
        n = whole.shape[3] // SHAPE[1]
        m = coords["model"]
        out = out[:, :, :, m * n:(m + 1) * n]
    return out
