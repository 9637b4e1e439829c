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


def flat(tree, prefix="") -> dict:
    """A cache (or its shardings) as ``{path: leaf}``: tensors as numpy
    copies, :class:`~repro_torch.launch.mesh.Sharding` as their spec
    tuples, ``idx`` as an int; an absent ``tail`` gives nothing."""
    if tree is None:
        return {}
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, torch.Tensor):
        return {prefix: tree.cpu().numpy().copy()}
    if isinstance(tree, meshlib.Sharding):
        return {prefix: tuple(tree.spec)}
    return {prefix: tree}


def _step_batch(step: dict, mesh=None, device="cpu"):
    """A fed step's batch (tokens, Whisper's frames) on the mesh's rows or,
    without a mesh, whole on ``device``."""
    if mesh is None:
        return {k: torch.from_numpy(v).to(device) for k, v in step.items()}
    return shard_batch(step, mesh=mesh, full_batch=False)


def _family_params(model, p0_np, device):
    """The reference's parameters carried over, or (``p0_np`` None) the
    port's own from a generator seeded 0 on ``device``."""
    if p0_np is None:
        return model.init(torch.Generator(device=device).manual_seed(0))
    return params_from_jax(p0_np, device=device)


def family_case(mesh, case, p0_np, feed):
    """One serving run of the SSM, hybrid or encoder-decoder family on the
    mesh from the reference's parameters (``_family_params``): ``feed``
    the reference's steps (dicts of tokens and, on a Whisper prefill,
    frames); a multi-token step is a prefill.  Returns this process's
    logits of every step, its cache block and the cache's specs by path,
    and the flash calls of every step."""
    _mesh(mesh)
    cfg = config(case["arch"], None, case["impl"])
    model = get_model(cfg)
    params = steps.local_state(_family_params(model, p0_np, mesh.device),
                               steps.mesh_param_shardings(model, mesh))
    cache = steps.local_cache(model, mesh, case["batch"], case["max_len"],
                              dtype=torch.float32)
    prefill = steps.build_prefill_step(model, mesh=mesh)
    decode = steps.build_decode_step(model, mesh=mesh)
    logits, flash = [], []
    for step in feed:
        fn = decode if step["tokens"].shape[1] == 1 else prefill
        with flash_calls() as calls:
            out, cache = fn(params, cache, _step_batch(step, mesh))
        logits.append(out.cpu().numpy())
        flash.append(calls)
    return {"coords": mesh.coords, "logits": logits, "flash": flash,
            "cache": flat(cache), "specs": flat(cache.shardings)}


def family_one_process(case, p0_np, feed, device="cpu"):
    """The same run through one process's steps on ``device``, in the
    test's process: every step's logits and the whole cache by path."""
    cfg = config(case["arch"], None, case["impl"])
    model = get_model(cfg)
    params = _family_params(model, p0_np, device)
    cache = model.init_cache(case["batch"], case["max_len"],
                             dtype=torch.float32, device=device)
    prefill = steps.build_prefill_step(model)
    decode = steps.build_decode_step(model)
    logits = []
    for step in feed:
        fn = decode if step["tokens"].shape[1] == 1 else prefill
        out, cache = fn(params, cache, _step_batch(step, device=device))
        logits.append(out.cpu().numpy())
    return logits, flat(cache)


def family_feed(arch, batch, prompt, cont, tokens, seed=0):
    """A fed run without the reference: a prompt (with Whisper's frames),
    a continuation of ``cont`` and the given decode ``tokens`` [batch, n],
    drawn from numpy seeded ``seed``."""
    cfg = config(arch)
    rng = np.random.default_rng(seed)
    feed = [{"tokens": rng.integers(1, cfg.vocab_size, (batch, prompt))
             .astype(np.int32)}]
    if cfg.encoder_layers:
        feed[0]["frames"] = rng.standard_normal(
            (batch, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    if cont:
        feed.append({"tokens": rng.integers(1, cfg.vocab_size, (batch, cont))
                     .astype(np.int32)})
    return feed + [{"tokens": np.ascontiguousarray(tokens[:, i:i + 1])}
                   for i in range(tokens.shape[1])]


def family_cases(mesh, cases, feeds):
    """``family_case`` of each case on the port's own seed-0 parameters."""
    return [family_case(mesh, c, None, f) for c, f in zip(cases, feeds)]


def families_all(mesh, cases, p0s, feeds, cells):
    """Every family case and the dry run's live serving cells of the three
    families, in one spawn."""
    _mesh(mesh)
    out = {"coords": mesh.coords,
           "cases": [family_case(mesh, c, p0s[c["ref"]], feeds[c["ref"]])
                     for c in cases], "dryrun": {}}
    for arch, shape, seq in cells:
        out["dryrun"][(arch, shape)] = dryrun.run_cell(
            arch, shape, mesh, cfg=config(arch), seq=seq, out_dir=None)
    return out


def graph_cell(mesh, n_vertices, n_edges, src_chunk):
    """The dry run's live graph cell on this process's rank of an R-MAT
    graph of ``n_vertices`` (seed 0) on its device."""
    from repro_torch.data import load_rmat_graph

    state = load_rmat_graph(n_vertices, n_edges, seed=0, device=mesh.device)
    return dryrun.run_graph_cell(mesh, state, src_chunk=src_chunk)


def spec_block(whole: np.ndarray, coords: dict, spec) -> np.ndarray:
    """A rank's block of a whole array under ``spec`` on the (2, 2)
    mesh."""
    sizes = dict(zip(("data", "model"), SHAPE))
    out = whole
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        n = whole.shape[dim] // sizes[entry]
        i = coords[entry]
        out = np.take(out, range(i * n, (i + 1) * n), axis=dim)
    return out
