"""The port's decoder-only LM against the reference on the CPU.

Reduced configs (4 layers, d 128, f32).  The reference's parameters are
carried over with ``params_from_jax``, so both compute the same function
on the same numpy tokens.  The reference's decoder-only models run its
``"xla"`` attention (its scanned per-layer windows never reach the Pallas
kernel), so that is the parity target: prefill logits, the KV cache and
six greedy decode steps, logits at rtol = atol = 1e-4 (f32 reassociation
over four layers) and identical tokens.  The port's flash path (the
kernel's plain version on the CPU) is held against its own ``"xla"`` path.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config, reduced as jax_reduced
from repro.models import get_model as jax_model
from repro_torch.configs import get_config, reduced
from repro_torch.models import get_model
from repro_torch.models.convert import params_from_jax

ARCHS = ["mistral_nemo_12b", "qwen3_32b", "codeqwen15_7b", "granite_moe_1b",
         "qwen2_vl_72b", "gemma3_27b", "llama4_maverick_400b"]
B, PROMPT, GEN = 2, 12, 6
TOL = dict(rtol=1e-4, atol=1e-4)


def _positions(rng, cfg, b, start, n):
    """[3, B, n] M-RoPE streams (t = position, h/w drawn) for the VLM,
    None (positions from the cache index) otherwise."""
    if not cfg.mrope_sections:
        return None
    t = np.broadcast_to(np.arange(start, start + n), (b, n))
    hw = rng.integers(0, 8, (2, b, n))
    return np.concatenate([t[None], hw]).astype(np.int32)


def _setup(arch, seed=0):
    jcfg = jax_reduced(jax_config(arch))
    jm = jax_model(jcfg)
    jparams = jm.init(jax.random.PRNGKey(seed))
    cfg = dataclasses.replace(reduced(get_config(arch)), attn_impl="xla")
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jm, jparams, cfg, params


def _run_jax(jm, jparams, tokens, max_len, pos_fn):
    prefill = jax.jit(lambda p, t, c, pos: jm.prefill(p, t, c, positions=pos))
    decode = jax.jit(lambda p, t, c, pos: jm.decode_step(p, t, c,
                                                        positions=pos))
    cache = jm.init_cache(tokens.shape[0], max_len, dtype=jnp.float32)
    pos = pos_fn(0, tokens.shape[1])
    logits, cache = prefill(jparams, jnp.asarray(tokens), cache,
                            None if pos is None else jnp.asarray(pos))
    steps = [np.asarray(logits)]
    caches = [jax.tree.map(np.asarray, cache)]
    toks = []
    for i in range(GEN):
        tok = np.asarray(jnp.argmax(logits[:, -1], axis=-1))[:, None]
        toks.append(tok)
        pos = pos_fn(tokens.shape[1] + i, 1)
        logits, cache = decode(jparams, jnp.asarray(tok), cache,
                               None if pos is None else jnp.asarray(pos))
        steps.append(np.asarray(logits))
    caches.append(jax.tree.map(np.asarray, cache))
    return steps, np.concatenate(toks, axis=1), caches


def _run_port(cfg, params, tokens, max_len, pos_fn, forced=None):
    """Prefill + GEN decode steps; ``forced`` feeds the given tokens
    instead of the port's own argmax (to compare logits step by step)."""
    m = get_model(cfg)
    cache = m.init_cache(tokens.shape[0], max_len, dtype=torch.float32,
                         device="cpu")

    def tpos(start, n):
        pos = pos_fn(start, n)
        return None if pos is None else torch.from_numpy(pos).long()

    logits, cache = m.prefill(params, torch.from_numpy(tokens).long(), cache,
                              positions=tpos(0, tokens.shape[1]))
    steps = [logits.numpy()]
    caches = [{"k": cache["k"].numpy().copy(), "v": cache["v"].numpy().copy(),
               "idx": cache["idx"]}]
    toks = []
    for i in range(GEN):
        tok = (forced[:, i:i + 1] if forced is not None
               else logits[:, -1].argmax(dim=-1)[:, None].numpy())
        toks.append(tok)
        logits, cache = m.decode_step(params, torch.from_numpy(tok).long(),
                                      cache,
                                      positions=tpos(tokens.shape[1] + i, 1))
        steps.append(logits.numpy())
    caches.append({"k": cache["k"].numpy(), "v": cache["v"].numpy(),
                   "idx": cache["idx"]})
    return steps, np.concatenate(toks, axis=1), caches


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_match_reference(arch):
    jcfg, jm, jparams, cfg, params = _setup(arch)
    rng = np.random.default_rng(7)
    tokens = rng.integers(1, cfg.vocab_size, (B, PROMPT)).astype(np.int32)
    pos_rng = np.random.default_rng(11)
    pos_table = {}

    def pos_fn(start, n):  # the same streams for both packages
        key = (start, n)
        if key not in pos_table:
            pos_table[key] = _positions(pos_rng, cfg, B, start, n)
        return pos_table[key]

    max_len = PROMPT + GEN + 3  # a cache longer than what is ever filled
    j_steps, j_toks, j_caches = _run_jax(jm, jparams, tokens, max_len,
                                         pos_fn)
    t_steps, t_toks, t_caches = _run_port(cfg, params, tokens, max_len,
                                          pos_fn)
    np.testing.assert_array_equal(t_toks, j_toks)
    for i, (got, exp) in enumerate(zip(t_steps, j_steps)):
        np.testing.assert_allclose(got, exp, **TOL,
                                   err_msg=f"{arch} step {i} logits")
    for got, exp in zip(t_caches, j_caches):
        assert got["idx"] == int(exp["idx"][0])
        np.testing.assert_allclose(got["k"], exp["k"], **TOL)
        np.testing.assert_allclose(got["v"], exp["v"], **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_flash_path_matches_xla_path(arch):
    """attn_impl="flash" (prefill through the kernel's plain version on the
    filled cache prefix) against the port's "xla" path, same weights."""
    _, _, _, cfg, params = _setup(arch, seed=1)
    rng = np.random.default_rng(3)
    tokens = rng.integers(1, cfg.vocab_size, (B, PROMPT)).astype(np.int32)
    pos = {}

    def pos_fn(start, n):
        return pos.setdefault((start, n), _positions(rng, cfg, B, start, n))

    max_len = PROMPT + GEN + 5
    x_steps, x_toks, x_caches = _run_port(cfg, params, tokens, max_len,
                                          pos_fn)
    fcfg = dataclasses.replace(cfg, attn_impl="flash")
    f_steps, _, f_caches = _run_port(fcfg, params, tokens, max_len, pos_fn,
                                     forced=x_toks)
    for got, exp in zip(f_steps, x_steps):
        np.testing.assert_allclose(got, exp, **TOL)
    np.testing.assert_allclose(f_caches[-1]["k"], x_caches[-1]["k"], **TOL)


def test_prefill_with_longer_cache_equals_reference_xla():
    """The reference's flash path is wrong when the cache is longer than
    the prompt (its kernel aligns the causal mask at the ends of the whole
    cache); the port gives the kernel the filled prefix only, so its flash
    prefill equals the reference's XLA answer."""
    arch = "mistral_nemo_12b"
    jcfg, jm, jparams, cfg, params = _setup(arch, seed=2)
    tokens = np.random.default_rng(5).integers(
        1, cfg.vocab_size, (B, 20)).astype(np.int32)
    max_len = 28
    jcache = jm.init_cache(B, max_len, dtype=jnp.float32)
    exp, _ = jax.jit(jm.prefill)(jparams, jnp.asarray(tokens), jcache)
    m = get_model(dataclasses.replace(cfg, attn_impl="flash"))
    got, cache = m.prefill(params, torch.from_numpy(tokens).long(),
                           m.init_cache(B, max_len, dtype=torch.float32,
                                        device="cpu"))
    assert cache["idx"] == 20
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), **TOL)


def test_continuation_prefill_matches_one_prefill():
    """A prompt prefilled in two pieces (the second with q_offset > 0 through
    the flash path) gives the logits and cache of one prefill."""
    _, _, _, cfg, params = _setup("qwen3_32b", seed=3)
    fcfg = dataclasses.replace(cfg, attn_impl="flash")
    m = get_model(fcfg)
    tokens = torch.from_numpy(np.random.default_rng(9).integers(
        1, cfg.vocab_size, (B, 18))).long()
    whole, c1 = m.prefill(params, tokens, m.init_cache(
        B, 24, dtype=torch.float32, device="cpu"))
    c2 = m.init_cache(B, 24, dtype=torch.float32, device="cpu")
    _, c2 = m.prefill(params, tokens[:, :11], c2)
    parts, c2 = m.prefill(params, tokens[:, 11:], c2)
    np.testing.assert_allclose(parts.numpy(), whole.numpy(), **TOL)
    np.testing.assert_allclose(c2["k"].numpy(), c1["k"].numpy(), **TOL)


@pytest.mark.parametrize("arch", ["mistral_nemo_12b", "granite_moe_1b"])
def test_reference_model_never_reaches_its_kernel(arch, monkeypatch):
    """Why the parity target is the reference's "xla" path: its layer scan
    carries the per-layer windows as a traced array, so even with
    attn_impl="flash" its attention never calls the Pallas kernel, while
    the port's prefill calls its kernel once per layer."""
    import repro.kernels.ops as jops
    import repro_torch.kernels.ops as tops

    counts = {"jax": 0, "port": 0}

    def counting(mod, key):
        orig = mod.flash_attention

        def wrapped(*a, **kw):
            counts[key] += 1
            return orig(*a, **kw)
        monkeypatch.setattr(mod, "flash_attention", wrapped)

    counting(jops, "jax")
    counting(tops, "port")
    jcfg, _, jparams, cfg, params = _setup(arch)
    jm = jax_model(dataclasses.replace(jcfg, attn_impl="flash"))
    tokens = np.ones((B, 8), np.int32)
    jm.prefill(jparams, jnp.asarray(tokens),
               jm.init_cache(B, 16, dtype=jnp.float32))
    m = get_model(dataclasses.replace(cfg, attn_impl="flash"))
    m.prefill(params, torch.from_numpy(tokens).long(),
              m.init_cache(B, 16, dtype=torch.float32, device="cpu"))
    assert counts == {"jax": 0, "port": cfg.num_layers}


def test_configs_and_registry():
    from repro_torch.configs import ARCHS as T_ARCHS, SHAPES as T_SHAPES
    from repro.configs import ARCHS as J_ARCHS, SHAPES as J_SHAPES

    assert T_ARCHS == J_ARCHS and T_SHAPES == J_SHAPES
    for arch in ARCHS:
        t, j = get_config(arch), jax_config(arch)
        assert t.params_dense() == j.params_dense()
        assert t.params_active() == j.params_active()
        assert t.dtype == torch.bfloat16 and t.attn_impl == "flash"
        for f in dataclasses.fields(j):
            if f.name not in ("dtype", "moment_dtype", "attn_impl"):
                assert getattr(t, f.name) == getattr(j, f.name), f.name
    assert get_config("llama4_maverick_400b").moment_dtype == \
        torch.float8_e5m2
    with pytest.raises(ValueError, match="has no config 'gpt2'"):
        get_config("gpt2")
    with pytest.raises(ValueError, match="unknown family"):
        get_model(dataclasses.replace(get_config("qwen3_32b"),
                                      family="rnn"))
