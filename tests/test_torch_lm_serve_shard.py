"""Sharded prefill and decode on a (data, model) mesh of processes
(``launch.steps.build_prefill_step(mesh=)`` / ``build_decode_step(mesh=)``,
``steps.local_cache``, ``shard_batch(full_batch=False)``, attention against
a KV cache whose sequence is split over ``model``, the MoE on serving's
rows, the dry run's prefill and decode cells) against the reference.

The port runs as four gloo processes on the CPU (``shard.spawn``; the rank
bodies are in ``tests/lm_serve_ranks.py``, which imports no JAX), once for
the whole module.  The reference runs once, in a JAX subprocess on four
placeholder devices (``conftest.run_multidevice``): its
``build_prefill_step`` / ``build_decode_step`` jitted with
``in_shardings`` as its dry run's ``lower_cell`` builds them (parameters
per ``model.specs()``, the cache per ``cache_specs``, the batch per
``batch_shardings(full_batch=False)``) under ``sharding_context(mesh,
full_batch=False)``, from ``model.init(PRNGKey(0))``, everything float32
on reduced configs.  Its greedy tokens feed both programs.  Every
prefill's and decode step's logits and each process's cache block are
held against the reference's to rtol = atol = 1e-5, over:

  * granite_moe_1b at capacity 1.25 (pairs drop), batch 4 (the MoE's
    ``gather_model`` layout) and 2: a 12-token prompt into a 32-row cache
    (16 rows a process), then 6 decode steps into the second block;
  * qwen3_32b (qk-norm), the same prompt and a continuation of 8 tokens at
    ``idx = 12`` across the block border (the flash path's gathered
    prefix; the "xla" path's split keys beside it);
  * gemma3_27b (window 16) in a 64-row cache: a 48-token prompt, 4 decode
    steps, whose window misses rank 0's block;
  * qwen2_vl_72b with M-RoPE positions;
  * qwen3_32b with ``max_len = 33``, which ``model`` does not divide: the
    cache stays whole on every process, as the reference's sanitized spec
    leaves it.

The SSM, hybrid and encoder-decoder families are held the same way in
``tests/test_torch_lm_serve_shard_families.py``.
"""
import pickle

import numpy as np
import pytest

import repro_torch.shard as ts
from repro_torch.launch import dryrun, mesh as meshlib
from repro_torch.models import get_model, param_shapes
from repro_torch.optim.tree import tree_leaves

import lm_serve_ranks as sr
from conftest import run_multidevice

JOIN = 300.0
TIMEOUT = 60.0
TOL = dict(rtol=1e-5, atol=1e-5)

# The reference's runs: name -> (arch, capacity, batch, max_len, prompt,
# continuation, decode steps).
REF_CASES = {
    "granite-b4": ("granite_moe_1b", 1.25, 4, 32, 12, 0, 6),
    "granite-b2": ("granite_moe_1b", 1.25, 2, 32, 12, 0, 6),
    "qwen3-cont": ("qwen3_32b", None, 4, 32, 12, 8, 4),
    "gemma3-window": ("gemma3_27b", None, 2, 64, 48, 0, 4),
    "qwen2vl-mrope": ("qwen2_vl_72b", None, 4, 32, 12, 0, 4),
    "qwen3-whole-cache": ("qwen3_32b", None, 4, 33, 12, 0, 4),
}
# The port's runs: (reference run, attention path).
CASES = [(name, "flash") for name in REF_CASES] + [("qwen3-cont", "xla")]
# The dry run's live cells, at a cut sequence.
CELLS = [(a, s, 32) for a in ("granite_moe_1b", "qwen3_32b")
         for s in ("prefill_32k", "decode_32k")]

REF_SCRIPT = r'''
import dataclasses, pickle
import numpy as np, jax, jax.numpy as jnp
from repro.configs import get_config, reduced
from repro.launch import mesh as meshlib, steps as steplib
from repro.models import get_model
from repro.models.sharding_ctx import sharding_context

OUT, CASES = %(out)r, %(cases)r
mesh = jax.make_mesh((2, 2), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
npt = lambda t: jax.tree.map(np.asarray, t)
sds = lambda t: jax.tree.map(
    lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), t)
coords = {d.id: (i, j) for i, row in enumerate(mesh.devices)
          for j, d in enumerate(row)}
def shards(a):
    return {coords[s.device.id]: np.asarray(s.data)
            for s in a.addressable_shards}
res = {"p0": {}, "feed": {}, "logits": {}, "k": {}, "v": {}}
for name, (arch, cap, b, max_len, prompt, cont, n_dec) in CASES.items():
    cfg = reduced(get_config(arch))
    if cap is not None:
        cfg = dataclasses.replace(cfg, capacity_factor=cap)
    m = get_model(cfg)
    p = m.init(jax.random.PRNGKey(0))
    res["p0"][name] = npt(p)
    rng = np.random.default_rng(len(name))
    def batch_of(tokens, start):
        bt = {"tokens": tokens}
        if cfg.mrope_sections:          # three distinct position streams
            s = np.arange(start, start + tokens.shape[1], dtype=np.int32)
            bt["positions"] = np.stack(
                [np.broadcast_to(x, tokens.shape) for x in
                 (s, s // 2, s %% 5 + 3 * np.arange(b)[:, None])]
            ).astype(np.int32)
        return bt
    feed = [batch_of(rng.integers(1, cfg.vocab_size, (b, prompt))
                     .astype(np.int32), 0)]
    if cont:
        feed.append(batch_of(rng.integers(1, cfg.vocab_size, (b, cont))
                             .astype(np.int32), prompt))
    logits = []
    with mesh, sharding_context(mesh, full_batch=False):
        psh = meshlib.sanitize_shardings(m.specs(), sds(p), mesh)
        cache = m.init_cache(b, max_len, dtype=jnp.float32)
        csh = steplib.cache_shardings(m, mesh, sds(cache))
        p, cache = jax.device_put(p, psh), jax.device_put(cache, csh)
        fns = {}
        def run(bt, kind):
            global cache
            bsh = meshlib.batch_shardings(sds(bt), mesh, full_batch=False)
            key = (kind, tuple(bt["tokens"].shape))
            if key not in fns:
                build = (steplib.build_prefill_step if kind == "prefill"
                         else steplib.build_decode_step)
                fns[key] = jax.jit(build(m), in_shardings=(psh, csh, bsh))
            out, cache = fns[key](p, jax.device_put(cache, csh),
                                  jax.device_put(bt, bsh))
            logits.append(np.asarray(out))
        for bt in feed:
            run(bt, "prefill")
        idx = prompt + cont
        for i in range(n_dec):
            tok = logits[-1][:, -1].argmax(-1).astype(np.int32)[:, None]
            feed.append(batch_of(tok, idx + i))
            run(feed[-1], "decode")
        cache = jax.device_put(cache, csh)
    res["feed"][name] = feed
    res["logits"][name] = logits
    res["k"][name] = shards(cache["k"])
    res["v"][name] = shards(cache["v"])

rng = np.random.default_rng(3)
batch = {"tokens": rng.integers(1, 100, (4, 9)).astype(np.int32),
         "positions": rng.integers(0, 50, (3, 4, 8)).astype(np.int32)}
res["batch_np"] = batch
bsh = meshlib.batch_shardings(sds(batch), mesh, full_batch=False)
res["batch"] = {k: shards(jax.device_put(v, bsh[k]))
                for k, v in batch.items()}
res["batch_spec"] = {k: tuple(v.spec) for k, v in bsh.items()}
with open(OUT, "wb") as f:
    pickle.dump(res, f)
print("REF OK")
'''


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("lm_serve_ref") / "ref.pkl")
    run_multidevice(REF_SCRIPT % dict(out=out, cases=REF_CASES))
    with open(out, "rb") as f:
        return pickle.load(f)


def _case(name, impl):
    arch, cap, b, max_len, _, _, _ = REF_CASES[name]
    return dict(arch=arch, capacity=cap, impl=impl, batch=b,
                max_len=max_len, ref=name)


def _feed(steps):
    return [(s["tokens"], s.get("positions")) for s in steps]


def _vocab_inputs():
    """An embedding table [V, d], a head [d, V], tokens over the whole
    vocabulary [B, S] and hidden states [B, 1, d] (float32, seed 5)."""
    rng = np.random.default_rng(5)
    v, d = 64, 16
    return (rng.standard_normal((v, d)).astype(np.float32),
            rng.standard_normal((d, v)).astype(np.float32),
            rng.integers(0, v, (2, 7)).astype(np.int32),
            rng.standard_normal((2, 1, d)).astype(np.float32))


@pytest.fixture(scope="module")
def runs(ref):
    cases = [_case(n, i) for n, i in CASES]
    feeds = {n: _feed(ref["feed"][n]) for n in REF_CASES}
    return ts.spawn(sr.serve_all, 4, device="cpu", transport="gloo",
                    timeout=TIMEOUT, join_timeout=JOIN,
                    args=(cases, ref["p0"], feeds, ref["batch_np"], CELLS,
                          _vocab_inputs()))


def test_vocab_local_embedding_and_head(runs):
    """In serving the embedding and the head are read by vocabulary block
    where they lie: the lookup sums one nonzero row over ``model`` (the
    gathered table's rows bit for bit) and the head's logits are gathered
    by column (its whole product); they move a [B, S, d] sum and [B, 1, V]
    logits where training's path gathers the [V, d] table and [d, V]
    head."""
    table, head, tokens, h = _vocab_inputs()
    for o in runs:
        loc, gat = o["vocab"]["local"], o["vocab"]["gathered"]
        np.testing.assert_array_equal(loc["rows"], gat["rows"])
        np.testing.assert_array_equal(loc["rows"], table[tokens])
        np.testing.assert_allclose(loc["logits"], gat["logits"], rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(loc["logits"], h @ head, rtol=1e-5,
                                   atol=1e-5)
        assert loc["bytes"] == {"all-reduce": tokens.size * 16 * 4,
                                "all-gather": h.shape[0] * 64 * 4}
        assert gat["bytes"] == {"all-gather": 2 * table.nbytes}


@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=[f"{n}-{i}" for n, i in CASES])
def test_mesh_serving_matches_reference(i, ref, runs):
    """Each process's logits (its data row's batch rows) of every prefill
    and decode step, and its cache block, against the reference's four
    devices; the ``model`` ranks of a data row hold the same bits."""
    name, impl = CASES[i]
    _, _, b, max_len, _, _, _ = REF_CASES[name]
    rows = b // 2
    by = {(o["coords"]["data"], o["coords"]["model"]): o["cases"][i]
          for o in runs}
    for (d, m), got in by.items():
        want = ref["logits"][name]
        assert len(got["logits"]) == len(want)
        for j, (g, w) in enumerate(zip(got["logits"], want)):
            np.testing.assert_allclose(g, w[d * rows:(d + 1) * rows], **TOL,
                                       err_msg=f"{name} step {j} rank {d, m}")
        for key in ("k", "v"):
            np.testing.assert_allclose(got[key], ref[key][name][(d, m)],
                                       **TOL, err_msg=f"{name} {key}")
        twin = by[(d, 1 - m)]
        for g, t in zip(got["logits"], twin["logits"]):
            np.testing.assert_array_equal(g, t)
        assert got["idx"] == sum(s["tokens"].shape[1]
                                 for s in ref["feed"][name])


@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=[f"{n}-{i}" for n, i in CASES])
def test_cache_blocks_and_flash_calls(i, runs):
    """``local_cache`` holds ``max_len / model`` rows a process (the whole
    ``max_len`` where ``model`` does not divide it, as the sanitized spec
    says); a flash prefill calls the kernel once a layer, on the fresh
    K/V at ``idx`` 0 and on the gathered prefix after it, and a decode
    step never; ``moe.drop_tally`` counts the pairs granite's buckets drop
    at capacity 1.25 (the dispatch the reference's parity holds)."""
    name, impl = CASES[i]
    arch, _, b, max_len, prompt, cont, n_dec = REF_CASES[name]
    cfg = sr.config(arch)
    split = max_len % 2 == 0
    for o in runs:
        got = o["cases"][i]
        assert got["spec"] == (None, "data", None,
                               "model" if split else None, None)
        assert got["k"].shape == (cfg.num_layers, b // 2, cfg.num_kv_heads,
                                  max_len // 2 if split else max_len,
                                  cfg.head_dim)
        want = ([[prompt] * cfg.num_layers]
                + ([[prompt + cont] * cfg.num_layers] if cont else [])
                + [[]] * n_dec) if impl == "flash" else [[]] * (
                    1 + bool(cont) + n_dec)
        assert got["flash"] == want
    drops = sum(o["cases"][i]["drops"] for o in runs)
    assert (drops > 0) == (arch == "granite_moe_1b"), drops


def test_one_process_matches_the_mesh(ref, runs):
    """The one-process steps on the same weights and tokens give the
    mesh's logits and, gathered, its cache (granite at capacity 1.25
    drops other pairs on one process, so qwen3's continuation)."""
    name = "qwen3-cont"
    logits, k, _ = sr.one_process(_case(name, "flash"), ref["p0"][name],
                                  _feed(ref["feed"][name]))
    for o in runs:
        got = o["cases"][CASES.index((name, "flash"))]
        d = o["coords"]["data"]
        for g, w in zip(got["logits"], logits):
            np.testing.assert_allclose(g, w[2 * d:2 * d + 2], **TOL)
        np.testing.assert_allclose(
            got["k"], sr.block_of(k, o["coords"], got["spec"]), **TOL)


def test_shard_batch_serving_rows_match_reference(ref, runs):
    """``shard_batch(mesh=, full_batch=False)``: each process's rows (the
    M-RoPE positions' batch on axis 1) against the reference's addressable
    shards under ``batch_shardings(full_batch=False)``."""
    for o in runs:
        coords = (o["coords"]["data"], o["coords"]["model"])
        for k, v in o["rows"].items():
            np.testing.assert_array_equal(v, ref["batch"][k][coords])
        assert o["row_specs"] == ref["batch_spec"]
        assert o["row_specs"]["positions"] == (None, "data", None)


def _gathered_bytes(like, sh, sizes, skip=()):
    """Result bytes of the all-gathers that rebuild each leaf of ``like``
    from its block (``sh``), the subtrees under ``skip`` kept."""
    total = 0
    for key in like:
        if key in skip:
            continue
        for t, s in zip(tree_leaves(like[key]), tree_leaves(sh[key])):
            size = t.element_size()
            for n in s.local_shape(tuple(t.shape)):
                size *= n
            for entry in s.spec:
                for a in reversed(meshlib._names(entry)):
                    size *= sizes[a]
                    total += size
    return total


def _moe_bytes(cfg, tokens: int, nd: int) -> dict:
    """The expert-parallel MoE's collectives on one data row's ``tokens``
    (``moe_shard_map`` without the ``gather_model`` relayout): the
    dispatch's and return's all-to-alls, the TP psum and the load-balance
    loss's pmean."""
    k, e_row, d = cfg.top_k, cfg.num_experts // nd, cfg.d_model
    cap = max(1, -(-tokens * k * int(cfg.capacity_factor * 100) // 100
                   // nd))
    tr = nd * cap
    c2 = max(1, -(-tr * 13 // (10 * e_row)))
    return {"all-to-all": tr * d * 4 + tr * 8 + tr * d * 4,
            "all-reduce": e_row * c2 * d * 4 + 4}


@pytest.mark.parametrize("cell", CELLS, ids=lambda c: f"{c[0]}-{c[1]}")
def test_dryrun_serving_bytes_match_layouts(cell, runs):
    """The live prefill and decode cells' per-layer collective bytes
    (depth 2 less depth 1) against a count from the layouts: each layer's
    gathered parameters (the experts' blocks kept), the MoE's collectives
    on the data row's tokens, and, a decode step, the split keys'
    softmax combine (a pmax of the row maxima and one psum of the sums and
    weights); depth 1 adds the vocabulary-local embedding's sum and the
    head's gathered logits, and the full count extrapolates per layer."""
    arch, shape, seq = cell
    rec = runs[0]["dryrun"][(arch, shape)]
    cfg = sr.config(arch)
    mesh = dryrun.mesh_layout((2, 2))
    sizes = dict(zip(mesh.axis_names, mesh.shape))
    model = get_model(dryrun.scale_depth(cfg, 1))
    like = param_shapes(model)
    sh = meshlib.sanitize_shardings(model.specs(), like, mesh)
    decode = shape.startswith("decode")
    rows = 1                                    # one sequence a data row
    layer = {"all-gather": _gathered_bytes(
        like["layers"][0], sh["layers"][0], sizes,
        skip=("ffn",) if cfg.num_experts else ())}
    if cfg.num_experts:
        for op, n in _moe_bytes(cfg, rows * (1 if decode else seq),
                                2).items():
            layer[op] = layer.get(op, 0) + n
    if decode:
        h, d = cfg.num_heads, cfg.head_dim
        layer["all-reduce"] = layer.get("all-reduce", 0) + (
            rows * h * 4 + rows * h * (d + 1) * 4)
    # the embedding's rows summed over model, the head's logits gathered
    edges = {"all-reduce": rows * (1 if decode else seq) * cfg.d_model * 4,
             "all-gather": rows * cfg.vocab_size * 4}
    d1, d2 = (rec[f"depth{d}"]["collectives"] for d in (1, 2))
    per_layer = {k: d2.get(k, 0) - d1.get(k, 0) for k in set(d1) | set(d2)}
    assert {k: v for k, v in per_layer.items() if v} == layer
    assert d1 == {k: layer.get(k, 0) + edges.get(k, 0)
                  for k in set(layer) | set(edges)}
    units = cfg.num_layers
    assert rec["full"]["collectives"] == {
        k: d1[k] + (units - 1) * layer.get(k, 0) for k in d1}
    assert rec["reduced"] == {"batch": [128 if decode else 32, 2],
                              "seq": [32768, seq]}
