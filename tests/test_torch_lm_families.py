"""The port's SSM, hybrid and encoder-decoder LMs (mamba2_780m, zamba2_12b,
whisper_large_v3) against the reference on the CPU.

Reduced configs (f32): the reference's parameters are carried over with
``params_from_jax``, so both packages compute the same function on the
same numpy tokens (and, for Whisper, frames).  The parity target is the
reference's ``"xla"`` path: prefill logits, every cache leaf and six greedy
decode steps, at rtol = atol = 1e-4, with identical tokens.  The prompt (21
tokens) is longer than one SSD chunk (16) and not a multiple of it, so the
prefill pads and carries state across chunks.  The port's flash path (the
kernel's plain version on the CPU) is held against its own ``"xla"`` path;
Whisper's encoder on the flash path against the reference's, which runs
the Pallas kernel in interpret mode, non causally.  The reference's flash
path with a cache longer than the prompt is wrong (its kernel is handed the
whole cache and aligns the causal mask at its end); that is pinned here for
both families that reach it.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config, reduced as jax_reduced
from repro.models import encdec as JE
from repro.models import get_model as jax_model
from repro_torch.configs import get_config, reduced
from repro_torch.models import encdec as TE
from repro_torch.models import get_model
from repro_torch.models.convert import STACKED, params_from_jax

ARCHS = ["mamba2_780m", "zamba2_12b", "whisper_large_v3"]
ATTN_ARCHS = ["zamba2_12b", "whisper_large_v3"]
B, PROMPT, GEN = 2, 21, 6
TOL = dict(rtol=1e-4, atol=1e-4)


def _setup(arch, seed=0):
    jcfg = jax_reduced(jax_config(arch))
    jm = jax_model(jcfg)
    jparams = jm.init(jax.random.PRNGKey(seed))
    cfg = dataclasses.replace(reduced(get_config(arch)), attn_impl="xla")
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jm, jparams, cfg, params


def _frames(cfg, seed=11):
    if cfg.family not in ("encdec", "audio"):
        return None
    return np.random.default_rng(seed).standard_normal(
        (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)


def _flat(tree, prefix=""):
    """Path -> numpy leaf (a torch leaf copied, so later in-place writes
    do not reach it); ``idx`` as a Python int."""
    if tree is None:
        return {}
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, int):
        return {prefix: tree}
    if isinstance(tree, torch.Tensor):
        return {prefix: tree.numpy().copy()}
    return {prefix: np.asarray(tree)}


def _same_caches(got, exp):
    """Flattened caches equal leaf for leaf; ``idx`` is one int in the port
    and one per layer (all equal) in the reference."""
    assert sorted(got) == sorted(exp)
    for path, val in exp.items():
        if path.endswith("/idx"):
            assert np.all(val == got[path]), path
        else:
            np.testing.assert_allclose(got[path], val, **TOL, err_msg=path)


def _run_jax(jm, jparams, tokens, max_len, frames):
    extra = {} if frames is None else {"frames": jnp.asarray(frames)}
    prefill = jax.jit(lambda p, t, c, kw: jm.prefill(p, t, c, **kw))
    decode = jax.jit(jm.decode_step)
    cache = jm.init_cache(tokens.shape[0], max_len, dtype=jnp.float32)
    logits, cache = prefill(jparams, jnp.asarray(tokens), cache, extra)
    steps, caches, toks = [np.asarray(logits)], [_flat(cache)], []
    for _ in range(GEN):
        tok = np.asarray(jnp.argmax(logits[:, -1], axis=-1))[:, None]
        toks.append(tok)
        logits, cache = decode(jparams, jnp.asarray(tok), cache)
        steps.append(np.asarray(logits))
    caches.append(_flat(cache))
    return steps, np.concatenate(toks, axis=1), caches


def _run_port(cfg, params, tokens, max_len, frames, forced=None):
    """Prefill + GEN decode steps; ``forced`` feeds the given tokens
    instead of the port's own argmax (to compare logits step by step)."""
    m = get_model(cfg)
    extra = {} if frames is None else {"frames": torch.from_numpy(frames)}
    cache = m.init_cache(tokens.shape[0], max_len, dtype=torch.float32,
                         device="cpu")
    logits, cache = m.prefill(params, torch.from_numpy(tokens).long(), cache,
                              **extra)
    steps, caches, toks = [logits.numpy()], [_flat(cache)], []
    for i in range(GEN):
        tok = (forced[:, i:i + 1] if forced is not None
               else logits[:, -1].argmax(dim=-1)[:, None].numpy())
        toks.append(tok)
        logits, cache = m.decode_step(params, torch.from_numpy(tok).long(),
                                      cache)
        steps.append(logits.numpy())
    caches.append(_flat(cache))
    return steps, np.concatenate(toks, axis=1), caches


def _tokens(cfg, seed, n=PROMPT):
    return np.random.default_rng(seed).integers(
        1, cfg.vocab_size, (B, n)).astype(np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_match_reference(arch):
    jcfg, jm, jparams, cfg, params = _setup(arch)
    tokens, frames = _tokens(cfg, 7), _frames(cfg)
    max_len = PROMPT + GEN + 3  # a cache longer than what is ever filled
    j_steps, j_toks, j_caches = _run_jax(jm, jparams, tokens, max_len,
                                         frames)
    t_steps, t_toks, t_caches = _run_port(cfg, params, tokens, max_len,
                                          frames)
    np.testing.assert_array_equal(t_toks, j_toks)
    for i, (got, exp) in enumerate(zip(t_steps, j_steps)):
        np.testing.assert_allclose(got, exp, **TOL,
                                   err_msg=f"{arch} step {i} logits")
    for got, exp in zip(t_caches, j_caches):
        _same_caches(got, exp)


@pytest.mark.parametrize("arch", ATTN_ARCHS)
def test_flash_path_matches_xla_path(arch):
    """attn_impl="flash" (prefill through the kernel's plain version: the
    filled prefix of a self-attention cache, the whole encoder K/V of a
    cross-attention) against the port's "xla" path, same weights."""
    _, _, _, cfg, params = _setup(arch, seed=1)
    tokens, frames = _tokens(cfg, 3), _frames(cfg, 5)
    max_len = PROMPT + GEN + 5
    x_steps, x_toks, x_caches = _run_port(cfg, params, tokens, max_len,
                                          frames)
    fcfg = dataclasses.replace(cfg, attn_impl="flash")
    f_steps, _, f_caches = _run_port(fcfg, params, tokens, max_len, frames,
                                     forced=x_toks)
    for got, exp in zip(f_steps, x_steps):
        np.testing.assert_allclose(got, exp, **TOL)
    for path, val in x_caches[-1].items():
        if not path.endswith("/idx"):
            np.testing.assert_allclose(f_caches[-1][path], val, **TOL,
                                       err_msg=path)


def _count_flash(monkeypatch):
    """Count the calls of both packages' ``ops.flash_attention``."""
    import repro.kernels.ops as jops
    import repro_torch.kernels.ops as tops

    counts = {"jax": 0, "port": 0}
    for mod, key in ((jops, "jax"), (tops, "port")):
        orig = mod.flash_attention

        def wrapped(*a, _orig=orig, _key=key, **kw):
            counts[_key] += 1
            return _orig(*a, **kw)
        monkeypatch.setattr(mod, "flash_attention", wrapped)
    return counts


def test_encode_matches_reference_pallas_kernel(monkeypatch):
    """Whisper's encoder with attn_impl="flash": the reference runs its
    Pallas kernel (interpret mode on the CPU) non causally in every layer,
    the port the kernel's plain version; the outputs agree."""
    counts = _count_flash(monkeypatch)
    jcfg, _, jparams, cfg, params = _setup("whisper_large_v3", seed=2)
    frames = _frames(cfg, 9)
    exp = JE.encode(jparams, jnp.asarray(frames),
                    dataclasses.replace(jcfg, attn_impl="flash"))
    got = TE.encode(params, torch.from_numpy(frames),
                    dataclasses.replace(cfg, attn_impl="flash"))
    # the reference traces its scanned layer body once
    assert counts == {"jax": 1, "port": cfg.encoder_layers}
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), **TOL)
    xla = TE.encode(params, torch.from_numpy(frames), cfg)
    np.testing.assert_allclose(xla.numpy(), np.asarray(exp), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_flash_launches(arch, monkeypatch):
    """One flash call per attention of a prefill: none for Mamba2, one per
    shared-block invocation for Zamba2, three per layer for Whisper
    (encoder, decoder self, cross); decode makes none."""
    counts = _count_flash(monkeypatch)
    _, _, _, cfg, params = _setup(arch, seed=3)
    cfg = dataclasses.replace(cfg, attn_impl="flash")
    m = get_model(cfg)
    frames = _frames(cfg)
    extra = {} if frames is None else {"frames": torch.from_numpy(frames)}
    cache = m.init_cache(B, PROMPT + 2, dtype=torch.float32, device="cpu")
    logits, cache = m.prefill(params, torch.from_numpy(_tokens(cfg, 1)).long(),
                              cache, **extra)
    if arch == "mamba2_780m":
        expected = 0
    elif arch == "zamba2_12b":
        expected = cfg.num_layers // cfg.attn_every
    else:
        expected = cfg.encoder_layers + 2 * cfg.num_layers
    assert counts["port"] == expected
    m.decode_step(params, logits[:, -1].argmax(-1)[:, None], cache)
    assert counts["port"] == expected


@pytest.mark.parametrize("arch", ATTN_ARCHS)
def test_reference_flash_path_with_longer_cache_vs_port(arch):
    """Reference fault 2 reaches these families: Whisper's decoder
    self-attention and Zamba2's shared block run with a cache and a static
    ``window=None``, so with attn_impl="flash" the reference hands its
    kernel the whole ``max_len`` cache and aligns the causal mask at its
    end: with a cache longer than the prompt its logits are wrong, with one
    exactly as long they are right.  The port's flash path (the filled
    prefix only) equals the reference's "xla" answer either way."""
    jcfg, jm, jparams, cfg, params = _setup(arch, seed=4)
    tokens, frames = _tokens(cfg, 8), _frames(cfg, 6)
    extra = {} if frames is None else {"frames": jnp.asarray(frames)}
    jflash = jax_model(dataclasses.replace(jcfg, attn_impl="flash"))

    def ref(model, max_len):
        cache = model.init_cache(B, max_len, dtype=jnp.float32)
        return np.asarray(jax.jit(lambda p, t, c, kw: model.prefill(
            p, t, c, **kw))(jparams, jnp.asarray(tokens), cache, extra)[0])

    exp = ref(jm, PROMPT + 8)
    wrong, right = ref(jflash, PROMPT + 8), ref(jflash, PROMPT)
    assert np.linalg.norm(wrong - exp) / np.linalg.norm(exp) > 0.1
    np.testing.assert_allclose(right, exp, **TOL)
    m = get_model(dataclasses.replace(cfg, attn_impl="flash"))
    textra = {} if frames is None else {"frames": torch.from_numpy(frames)}
    got, _ = m.prefill(params, torch.from_numpy(tokens).long(),
                       m.init_cache(B, PROMPT + 8, dtype=torch.float32,
                                    device="cpu"), **textra)
    np.testing.assert_allclose(got.numpy(), exp, **TOL)


def _restack(x, depth):
    """The port's nested per-layer lists -> the reference's stacked
    arrays."""
    if depth == 0:
        return x
    parts = [_restack(p, depth - 1) for p in x]
    return jax.tree.map(lambda *ls: np.stack(ls), *parts)


@pytest.mark.parametrize("arch", ARCHS)
def test_params_round_trip_and_init_layout(arch):
    """``params_from_jax`` carries every leaf over exactly, each stack
    unstacked into per-layer lists, with nothing shared between layers;
    the port's own ``init`` gives the same tree, shapes and dtypes."""
    jcfg, _, jparams, cfg, params = _setup(arch, seed=5)
    jnp_params = jax.tree.map(np.asarray, jparams)
    back = {k: _restack(jax.tree.map(lambda t: t.numpy(), v),
                        STACKED.get(k, 0))
            for k, v in params.items()}
    assert sorted(back) == sorted(jnp_params)
    jax.tree.map(np.testing.assert_array_equal, back, jnp_params)
    stack = params["blocks"][0] if arch == "zamba2_12b" else params.get(
        "layers", params.get("decoder"))
    a, b = jax.tree.leaves(stack[0]), jax.tree.leaves(stack[1])
    assert all(x.data_ptr() != y.data_ptr() for x, y in zip(a, b))

    own = get_model(cfg).init(torch.Generator().manual_seed(0))

    def layout(tree):
        return jax.tree.map(lambda t: (tuple(t.shape), t.dtype), tree)
    assert layout(own) == layout(params)


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_and_registry_match_reference(arch):
    t, j = get_config(arch), jax_config(arch)
    assert t.params_dense() == j.params_dense()
    assert t.dtype == torch.bfloat16 and t.attn_impl == "flash"
    for tc, jc in ((t, j), (reduced(t), jax_reduced(j))):
        for f in dataclasses.fields(jc):
            if f.name not in ("dtype", "moment_dtype", "attn_impl"):
                assert getattr(tc, f.name) == getattr(jc, f.name), f.name
    from repro.configs import LONG_OK_FAMILIES as J_LONG, shapes_for as j_sf
    from repro_torch.configs import LONG_OK_FAMILIES as T_LONG, shapes_for
    assert T_LONG == J_LONG and shapes_for(t) == j_sf(j)
    # get_model dispatches on the family: the caches have the reference's
    # layout, leaf for leaf (shapes, and idx as one int)
    rc, rj = reduced(t), jax_reduced(j)
    got = _flat(get_model(rc).init_cache(B, 9, dtype=torch.float32,
                                         device="cpu"))
    exp = _flat(jax_model(rj).init_cache(B, 9, dtype=jnp.float32))
    assert {k: np.shape(v) for k, v in got.items() if not k.endswith("idx")} \
        == {k: v.shape for k, v in exp.items() if not k.endswith("idx")}
    _same_caches(got, exp)
    assert get_model(t).cfg is t
