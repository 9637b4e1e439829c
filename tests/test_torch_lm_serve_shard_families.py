"""Sharded prefill and decode of the SSM, hybrid and encoder-decoder
families on a (data, model) mesh of processes (mamba2_780m, zamba2_12b,
whisper_large_v3: ``launch.steps.build_prefill_step(mesh=)`` /
``build_decode_step(mesh=)`` on ``steps.local_cache``, the dry run's
serving cells of the three, and its graph engine cell) against the
reference.

The port runs as four gloo processes on the CPU (``shard.spawn``; the rank
bodies are in ``tests/lm_serve_ranks.py``, which imports no JAX), once for
the module.  The reference runs once, in a JAX subprocess on four
placeholder devices (``conftest.run_multidevice``): its
``build_prefill_step`` / ``build_decode_step`` jitted with the
``in_shardings`` its dry run's ``lower_cell`` builds, on its ``"xla"``
attention (its flash path is wrong where the cache is longer than the
prompt), from ``model.init(PRNGKey(0))``, everything float32 on reduced
configs.  Its greedy tokens feed both programs.  Every prefill's and
decode step's logits and each process's block of every cache leaf
(``conv``, ``ssd``, the K/V, the cross K/V) are held against the
reference's to rtol = atol = 1e-5, and the ``model`` ranks of a data row
give the same bits, over:

  * mamba2_780m: a 21-token prompt (it pads and crosses an SSD chunk of
    16), a continuation of 8 and 4 decode steps; the ``conv`` block holds
    the x channels of 9 heads where the ``ssd`` block holds 8;
  * zamba2_12b (5 layers, ``attn_every`` 2: two super-blocks and a tail of
    one): a 12-token prompt and a continuation of 8 across the shared
    block's K/V block border at 16, on the flash and the ``"xla"`` paths;
  * whisper_large_v3 (24 frames, 12 a process): a 12-token prompt with
    frames, a continuation of 8 without (cross-attention on the split
    cross cache, merged over ``model``), 4 decode steps; and a cache of 33
    rows, which ``model`` does not divide: the self-attention's K/V stays
    whole while the cross K/V is split.
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

# The reference's runs: name -> (arch, batch, max_len, prompt,
# continuation, decode steps).
REF_CASES = {
    "mamba2": ("mamba2_780m", 4, 40, 21, 8, 4),
    "zamba2-cont": ("zamba2_12b", 4, 32, 12, 8, 4),
    "whisper": ("whisper_large_v3", 4, 32, 12, 8, 4),
    "whisper-33": ("whisper_large_v3", 4, 33, 12, 0, 4),
}
# The port's runs: (reference run, attention path).
CASES = [(name, "flash") for name in REF_CASES] + [("zamba2-cont", "xla")]
# The dry run's live cells of the three families, at a cut sequence.
CELLS = ([(a, s, 32) for a in ("mamba2_780m", "zamba2_12b")
          for s in ("prefill_32k", "decode_32k", "long_500k")]
         + [("whisper_large_v3", s, 32) for s in ("prefill_32k",
                                                   "decode_32k")])
# The live graph cell: an R-MAT graph, its BC sources in chunks of 4.
GRAPH = (256, 2048, 4)

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
def flat(tree, sh, prefix=""):
    if tree is None:
        return {}
    if isinstance(tree, dict):
        out = {}
        for k in tree:
            out.update(flat(tree[k], sh[k], f"{prefix}/{k}"))
        return out
    return {prefix: (shards(tree), tuple(sh.spec))}
res = {"p0": {}, "feed": {}, "logits": {}, "cache": {}}
for name, (arch, b, max_len, prompt, cont, n_dec) in CASES.items():
    cfg = dataclasses.replace(reduced(get_config(arch)), attn_impl="xla")
    m = get_model(cfg)
    p = m.init(jax.random.PRNGKey(0))
    res["p0"][name] = npt(p)
    rng = np.random.default_rng(len(name))
    feed = [{"tokens": rng.integers(1, cfg.vocab_size, (b, prompt))
             .astype(np.int32)}]
    if cfg.encoder_layers:
        feed[0]["frames"] = rng.standard_normal(
            (b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    if cont:
        feed.append({"tokens": rng.integers(1, cfg.vocab_size, (b, cont))
                     .astype(np.int32)})
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
            key = (kind,) + tuple(sorted((k, v.shape) for k, v in bt.items()))
            if key not in fns:
                build = (steplib.build_prefill_step if kind == "prefill"
                         else steplib.build_decode_step)
                fns[key] = jax.jit(build(m), in_shardings=(psh, csh, bsh))
            out, cache = fns[key](p, jax.device_put(cache, csh),
                                  jax.device_put(bt, bsh))
            logits.append(np.asarray(out))
        for bt in list(feed):
            run(bt, "prefill")
        for i in range(n_dec):
            tok = logits[-1][:, -1].argmax(-1).astype(np.int32)[:, None]
            feed.append({"tokens": tok})
            run(feed[-1], "decode")
        cache = jax.device_put(cache, csh)
    res["feed"][name] = feed
    res["logits"][name] = logits
    res["cache"][name] = flat(cache, csh)

from repro.core.partition import distributed_query_specs, make_distributed_query
gm = meshlib.make_graph_mesh(mesh)
res["graph"] = {}
for kind in ("bfs", "sssp", "bc", "bc_ring"):
    _, in_sh, _ = make_distributed_query(gm, kind)
    specs = distributed_query_specs(1000, gm, n_sources=8)
    res["graph"][kind] = [(tuple(a.shape), tuple(sh.shard_shape(a.shape)))
                          for a, sh in zip(specs, in_sh)]
with open(OUT, "wb") as f:
    pickle.dump(res, f)
print("REF OK")
'''


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("lm_serve_families_ref") / "ref.pkl")
    run_multidevice(REF_SCRIPT % dict(out=out, cases=REF_CASES))
    with open(out, "rb") as f:
        return pickle.load(f)


def _case(name, impl):
    arch, b, max_len, _, _, _ = REF_CASES[name]
    return dict(arch=arch, impl=impl, batch=b, max_len=max_len, ref=name)


@pytest.fixture(scope="module")
def runs(ref):
    cases = [_case(n, i) for n, i in CASES]
    return ts.spawn(sr.families_all, 4, device="cpu", transport="gloo",
                    timeout=TIMEOUT, join_timeout=JOIN,
                    args=(cases, ref["p0"], ref["feed"], CELLS))


def _by_coords(runs, i):
    return {(o["coords"]["data"], o["coords"]["model"]): o["cases"][i]
            for o in runs}


@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=[f"{n}-{i}" for n, i in CASES])
def test_mesh_serving_matches_reference(i, ref, runs):
    """Each process's logits (its data row's batch rows) of every prefill
    and decode step, and its block of every cache leaf, against the
    reference's four devices; the fill ``idx`` counts every fed token."""
    name, _ = CASES[i]
    b = REF_CASES[name][1]
    rows = b // 2
    want = ref["logits"][name]
    for (d, m), got in _by_coords(runs, i).items():
        assert len(got["logits"]) == len(want)
        for j, (g, w) in enumerate(zip(got["logits"], want)):
            np.testing.assert_allclose(g, w[d * rows:(d + 1) * rows], **TOL,
                                       err_msg=f"{name} step {j} rank {d, m}")
        tensors = {k for k, v in got["cache"].items()
                   if isinstance(v, np.ndarray)}
        assert tensors == {k for k in ref["cache"][name]
                           if not k.endswith("/idx")}
        for path in tensors:
            blocks, spec = ref["cache"][name][path]
            assert got["specs"][path] == spec, path
            np.testing.assert_allclose(got["cache"][path], blocks[(d, m)],
                                       **TOL, err_msg=f"{name} {path}")
        fed = sum(s["tokens"].shape[1] for s in ref["feed"][name])
        for path, v in got["cache"].items():
            if path.endswith("/idx"):
                assert v == fed, path


@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=[f"{n}-{i}" for n, i in CASES])
def test_model_ranks_agree_bit_for_bit(i, runs):
    """The ``model`` ranks of a data row serve the same rows: the same
    logits, bit for bit, at every step."""
    by = _by_coords(runs, i)
    for (d, m), got in by.items():
        for g, t in zip(got["logits"], by[(d, 1 - m)]["logits"]):
            np.testing.assert_array_equal(g, t)


@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=[f"{n}-{i}" for n, i in CASES])
def test_cache_blocks_are_split_and_flash_calls(i, runs):
    """Each state leaf is really split over ``model`` (the SSM's channels
    and heads, the K/V's sequence; Whisper's self K/V stays whole in a
    33-row cache), and a flash prefill calls the kernel on Zamba2's shared
    block at every invocation and on each of Whisper's encoder layers and
    decoder self- and cross-attentions; a prefill without frames attends to
    the split cross cache without it, and a decode step never calls it."""
    name, impl = CASES[i]
    arch, b, max_len, prompt, cont, n_dec = REF_CASES[name]
    cfg = sr.config(arch)
    got = runs[0]["cases"][i]
    # a layer's rank and the dimension "model" splits: conv [B, K-1, C],
    # ssd [B, H, Pd, N], K/V [B, KV, S, D]
    layer = {"conv": (3, 2), "ssd": (4, 1), "k": (4, 2), "v": (4, 2)}
    for path, spec in got["specs"].items():
        leaf = path.rsplit("/", 1)[-1]
        if leaf == "idx":
            continue
        lead = len(spec) - layer[leaf][0]
        dim = lead + layer[leaf][1]
        split = not (leaf in ("k", "v") and path.startswith("/self")
                     and max_len % 2)
        assert spec[dim] == ("model" if split else None), (path, spec)
        assert got["cache"][path].shape[lead] == b // 2, path
    fed = [prompt] + ([cont] if cont else []) + [1] * n_dec
    if impl == "xla" or cfg.family == "ssm":
        want = [[] for _ in fed]
    elif cfg.family == "hybrid":
        ns = cfg.num_layers // cfg.attn_every
        want = [[s] * ns if s > 1 else [] for s in fed]
        want[1] = [prompt + cont] * ns      # the gathered prefix
    else:
        nl = cfg.num_layers
        enc = [cfg.encoder_seq] * cfg.encoder_layers
        want = [enc + [prompt, cfg.encoder_seq] * nl] + [
            [prompt + s] * nl if s > 1 else [] for s in fed[1:]]
    assert got["flash"] == want


def test_one_process_matches_the_mesh(ref, runs):
    """The one-process steps on the same weights and tokens give the
    mesh's logits and, cut to each process's block, its cache (Whisper
    with frames, a prefill without, decode steps)."""
    for name in ("whisper", "mamba2"):
        i = CASES.index((name, "flash"))
        logits, cache = sr.family_one_process(_case(name, "flash"),
                                              ref["p0"][name],
                                              ref["feed"][name])
        for o in runs:
            got, d = o["cases"][i], o["coords"]["data"]
            for g, w in zip(got["logits"], logits):
                np.testing.assert_allclose(g, w[2 * d:2 * d + 2], **TOL)
            for path, spec in got["specs"].items():
                if not path.endswith("/idx"):
                    np.testing.assert_allclose(
                        got["cache"][path],
                        sr.spec_block(cache[path], o["coords"], spec),
                        **TOL, err_msg=path)


def _gathered_bytes(like, sh, sizes, keep=()):
    """Result bytes of the all-gathers that rebuild each leaf of ``like``
    from its block (``sh``), the keys of ``keep`` left as blocks."""
    total = 0
    for key in like:
        if key in keep:
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


def _state_bytes(cfg, rows):
    """One Mamba2 layer's state gathered over ``model``: the whole
    ``conv`` [rows, K-1, C] and ``ssd`` [rows, H, Pd, N], float32."""
    c = cfg.d_inner + 2 * cfg.ssm_state
    return 4 * rows * ((cfg.conv_kernel - 1) * c + cfg.ssm_heads
                       * cfg.ssm_headdim * cfg.ssm_state)


def _combine_bytes(cfg, rows, sq=1):
    """A split-key softmax combine: a pmax of the row maxima and one psum
    of the sums and weights."""
    h, d = cfg.num_heads, cfg.head_dim
    return rows * h * sq * 4 + rows * h * sq * (d + 1) * 4


def _add(a, b):
    return {k: a.get(k, 0) + b.get(k, 0) for k in set(a) | set(b)}


def _cell_bytes(cfg, shape, seq, rows):
    """``(a unit's bytes, the rest at depth 1)`` of a family's serving
    cell, from the layouts: each layer's gathered parameters, each Mamba2
    layer's gathered state, the split keys' combines of a decode step
    (self- and cross-attention), and the edges: the vocabulary-local
    embedding's sum and the head's gathered logits, the hybrid's shared
    block (gathered once a pass) and its tail."""
    mesh = dryrun.mesh_layout((2, 2))
    sizes = dict(zip(mesh.axis_names, mesh.shape))
    model = get_model(dryrun.scale_depth(cfg, 1))
    like = param_shapes(model)
    sh = meshlib.sanitize_shardings(model.specs(), like, mesh)
    prefill = shape.startswith("prefill")
    s = seq if prefill else 1
    edges = {"all-reduce": rows * s * cfg.d_model * 4,
             "all-gather": rows * cfg.vocab_size * 4}
    state = _state_bytes(cfg, rows) if cfg.ssm_state else 0
    if cfg.family == "ssm":
        return {"all-gather": _gathered_bytes(like["layers"][0],
                                              sh["layers"][0], sizes)
                + state}, edges
    if cfg.family == "hybrid":
        unit = {"all-gather": sum(_gathered_bytes(lp, shp, sizes) + state
                                  for lp, shp in zip(like["blocks"][0],
                                                     sh["blocks"][0]))}
        if not prefill:
            unit["all-reduce"] = _combine_bytes(cfg, rows)
        tail = sum(_gathered_bytes(lp, shp, sizes) + state
                   for lp, shp in zip(like.get("tail", ()),
                                      sh.get("tail", ())))
        return unit, _add(edges, {"all-gather": tail + _gathered_bytes(
            {"shared": like["shared"]}, {"shared": sh["shared"]}, sizes)})
    unit = {"all-gather": _gathered_bytes(like["decoder"][0],
                                          sh["decoder"][0], sizes)}
    if prefill:
        unit["all-gather"] += _gathered_bytes(
            like["encoder"][0], sh["encoder"][0], sizes) + _gathered_bytes(
            like["decoder"][0]["cross"], sh["decoder"][0]["cross"], sizes,
            keep=("wq", "wo"))
    else:
        unit["all-reduce"] = 2 * _combine_bytes(cfg, rows)
    return unit, edges


@pytest.mark.parametrize("cell", CELLS, ids=lambda c: f"{c[0]}-{c[1]}")
def test_dryrun_serving_bytes_match_layouts(cell, runs):
    """The live serving cells' collective bytes per unit (depth 2 less
    depth 1) and at depth 1 against a count from the layouts
    (``_cell_bytes``), the full count extrapolated per unit, and the cuts
    recorded (long_500k's batch of one is not cut)."""
    arch, shape, seq = cell
    rec = runs[0]["dryrun"][(arch, shape)]
    cfg = sr.config(arch)
    seq_full, gbatch, _ = dryrun.SHAPES[shape]
    rows = 1                                    # one sequence a data row
    unit, edges = _cell_bytes(cfg, shape, seq, rows)
    d1, d2 = (rec[f"depth{d}"]["collectives"] for d in (1, 2))
    per_unit = {k: d2.get(k, 0) - d1.get(k, 0) for k in set(d1) | set(d2)}
    assert {k: v for k, v in per_unit.items() if v} == unit
    assert d1 == _add(unit, edges)
    assert rec["full"]["collectives"] == {
        k: d1[k] + (rec["units"] - 1) * unit.get(k, 0) for k in d1}
    want = {"seq": [seq_full, seq]}
    if gbatch != rec["batch"]:
        want["batch"] = [gbatch, 2]
    assert rec["reduced"] == want
    assert rec["batch"] == min(gbatch, 2)


def test_graph_layout_cell_matches_reference(ref):
    """The graph cell's layout: per kind the padded ``vp`` and each
    argument's global and per-rank shape against the reference's
    ``distributed_query_specs`` and its queries' ``in_shardings`` on four
    placeholder devices, and the bytes a rank holds."""
    rec = dryrun.graph_layout_cell((2, 2), vcap=1000, bc_vcap=1000,
                                   n_sources=8)
    for kind, want in ref["graph"].items():
        got = rec[kind]
        assert [(tuple(a["shape"]), tuple(a["rank_shape"]))
                for a in got["args"]] == want, kind
        assert got["vp"] == want[0][0][0]
        sizes = {"float32": 4, "int32": 4, "bool": 1}
        assert got["argument_bytes"] == sum(
            int(np.prod(a["rank_shape"])) * sizes[a["dtype"]]
            for a in got["args"])
    big = dryrun.graph_layout_cell((16, 16))
    assert big["bc"]["vp"] == 32768 and big["bfs"]["vp"] == 131072
    assert big["bc"]["args"][4]["rank_shape"] == [2]


def test_graph_cell_live_bytes_match_thread_group():
    """The live graph cell in four gloo processes counts, per kind, the
    collective bytes the same queries count on four ranks of one process
    (``ThreadGroup``), and records its vertex capacity as cut."""
    from repro_torch.data import load_rmat_graph

    n, e, chunk = GRAPH
    outs = ts.spawn(sr.graph_cell, 4, device="cpu", transport="gloo",
                    timeout=TIMEOUT, join_timeout=JOIN, args=GRAPH)
    state = load_rmat_graph(n, e, seed=0, device="cpu")
    want = dryrun.run_graph_cell(ts.GraphMesh(["cpu"] * 4), state,
                                 src_chunk=chunk)
    for o in outs:
        assert o["reduced"] == {"vcap": [131072, n]}
        for kind in dryrun.GRAPH_KINDS:
            assert o[kind] == want[kind], kind
            assert o[kind], kind
