"""The port's layer library against the reference's, at f32 on the CPU.

The same numpy inputs and the reference's own initialised parameters go
through ``repro.models.layers`` / ``repro.models.moe`` and their ports.
Attention is compared on its three uses -- a prefill into a cache, one
decode step, and a continuation prefill with ``q_offset > 0`` -- on both of
the port's paths (``"flash"``: the kernel's plain version on the filled
prefix; ``"xla"``: the chunked attention), against the reference's XLA
path.  Tolerance 1e-5 (f32 reassociation).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config, reduced as jax_reduced
from repro.models import layers as JL
from repro.models import moe as JM
from repro_torch.configs import get_config, reduced
from repro_torch.models import layers as TL
from repro_torch.models import moe as TM

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _cfgs(arch, **kw):
    jcfg = dataclasses.replace(jax_reduced(jax_config(arch)), **kw)
    tcfg = dataclasses.replace(reduced(get_config(arch)), **kw)
    return jcfg, tcfg


def test_rms_norm():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3
    w = rng.standard_normal(64).astype(np.float32)
    exp = JL.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6)
    got = TL.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), **TOL)


@pytest.mark.parametrize("d,sections,streams", [
    (32, None, 1), (128, None, 1),
    (32, (16, 24, 24), 3),      # reduced VLM: sections clamp to the t stream
    (128, (16, 24, 24), 3),     # published VLM width: all three streams
])
def test_apply_rope(d, sections, streams):
    rng = np.random.default_rng(d)
    x = rng.standard_normal((2, 3, 7, d)).astype(np.float32)
    shape = (2, 7) if streams == 1 else (3, 2, 7)
    pos = rng.integers(0, 50, shape).astype(np.int32)
    exp = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6, sections)
    got = TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos).long(),
                        1e6, sections)
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), **TOL)


def _attn_setup(arch, seed):
    jcfg, tcfg = _cfgs(arch)
    jp = JL.init_attention(jax.random.PRNGKey(seed), jcfg)
    return jcfg, tcfg, jp, _t(jp)


@pytest.mark.parametrize("arch", ["mistral_nemo_12b", "qwen3_32b",
                                  "codeqwen15_7b"])
@pytest.mark.parametrize("impl", ["flash", "xla"])
@pytest.mark.parametrize("window", [None, 5])
def test_attention_prefill_decode_continuation(arch, impl, window):
    jcfg, tcfg, jp, tp = _attn_setup(arch, 1)
    tcfg = dataclasses.replace(tcfg, attn_impl=impl)
    rng = np.random.default_rng(2)
    b, smax, kv, hd = 2, 24, tcfg.num_kv_heads, tcfg.head_dim
    jcache = {"k": jnp.zeros((b, kv, smax, hd)), "v": jnp.zeros((b, kv, smax, hd)),
              "idx": jnp.int32(0)}
    tcache = {"k": torch.zeros((b, kv, smax, hd)),
              "v": torch.zeros((b, kv, smax, hd)), "idx": 0}
    # prefill 9, decode 1, continue with 6 (q_offset 10)
    for n in (9, 1, 6):
        x = rng.standard_normal((b, n, tcfg.d_model)).astype(np.float32)
        exp, jcache = JL.attention(jp, jnp.asarray(x), jcfg, cache=jcache,
                                   window=window)
        got, tcache = TL.attention(tp, torch.from_numpy(x), tcfg,
                                   cache=tcache, window=window)
        np.testing.assert_allclose(got.numpy(), np.asarray(exp), **TOL)
        assert tcache["idx"] == int(jcache["idx"])
        np.testing.assert_allclose(tcache["k"].numpy(),
                                   np.asarray(jcache["k"]), **TOL)
        np.testing.assert_allclose(tcache["v"].numpy(),
                                   np.asarray(jcache["v"]), **TOL)


@pytest.mark.parametrize("impl,softcap", [("flash", 0.0), ("xla", 0.0),
                                          ("flash", 2.0)])
def test_attention_without_cache_and_cross(impl, softcap):
    """No cache and cross-attention; a logit softcap (which sends even the
    flash config to the chunked attention, as in the reference)."""
    jcfg, tcfg, jp, tp = _attn_setup("mistral_nemo_12b", 3)
    jcfg = dataclasses.replace(jcfg, logit_softcap=softcap)
    tcfg = dataclasses.replace(tcfg, attn_impl=impl, logit_softcap=softcap)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 11, tcfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((2, 17, tcfg.d_model)).astype(np.float32)
    exp, _ = JL.attention(jp, jnp.asarray(x), jcfg)
    got, cache = TL.attention(tp, torch.from_numpy(x), tcfg)
    assert cache is None
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), **TOL)
    exp, _ = JL.attention(jp, jnp.asarray(x), jcfg, kv_x=jnp.asarray(enc))
    got, _ = TL.attention(tp, torch.from_numpy(x), tcfg,
                          kv_x=torch.from_numpy(enc))
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), **TOL)


@pytest.mark.parametrize("impl", ["flash", "xla"])
@pytest.mark.parametrize("sq", [11, 1])
def test_attention_cached_cross_and_no_rope(impl, sq):
    """The encoder-decoder's modes: cross-attention from a precomputed
    cache (``init_cross_kv``, ``kv_x="cached"``: no projection, no qk-norm,
    no RoPE, not causal, the cache returned as it is), on a prefill and a
    decode-sized query; and self-attention with ``use_rope=False``, not
    causal."""
    jcfg, tcfg, jp, tp = _attn_setup("qwen3_32b", 5)  # qk-norm on
    tcfg = dataclasses.replace(tcfg, attn_impl=impl)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, sq, tcfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((2, 19, tcfg.d_model)).astype(np.float32)
    jkv = JL.init_cross_kv(jp, jcfg, jnp.asarray(enc))
    tkv = TL.init_cross_kv(tp, tcfg, torch.from_numpy(enc))
    for key in ("k", "v"):
        np.testing.assert_allclose(tkv[key].numpy(), np.asarray(jkv[key]),
                                   **TOL)
    exp, jc = JL.attention(jp, jnp.asarray(x), jcfg, kv_x="cached",
                           cache=jkv, causal=False, use_rope=False)
    got, tc = TL.attention(tp, torch.from_numpy(x), tcfg, kv_x="cached",
                           cache=tkv, causal=False, use_rope=False)
    assert tc is tkv and jc is jkv
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), **TOL)
    exp, _ = JL.attention(jp, jnp.asarray(x), jcfg, causal=False,
                          use_rope=False)
    got, _ = TL.attention(tp, torch.from_numpy(x), tcfg, causal=False,
                          use_rope=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), **TOL)


@pytest.mark.parametrize("sq,skv,q_offset,causal,window", [
    (12, 12, 0, True, None), (12, 12, 0, True, 4), (7, 20, 13, True, 5),
    (9, 15, 0, False, None), (6, 10, 12, True, 3), (6, 10, 10, False, 2)])
def test_sdpa_chunked_matches_reference(sq, skv, q_offset, causal, window):
    """The chunked attention over chunks of 4 rows, against the reference's:
    causal, windowed, a continuation past the first rows, non-causal, and
    windows that leave rows with no key at all (zeros, not NaN)."""
    rng = np.random.default_rng(sq * skv + q_offset)
    q, k, v = (rng.standard_normal((2, 3, n, 16)).astype(np.float32)
               for n in (sq, skv, skv))
    exp = JL._sdpa_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           causal=causal, q_offset=jnp.int32(q_offset),
                           chunk=4, window=window)
    got = TL.sdpa_chunked(*(torch.from_numpy(a) for a in (q, k, v)),
                          causal=causal, q_offset=q_offset, chunk=4,
                          window=window)
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), **TOL)


def test_mlp_embed_unembed():
    jcfg, tcfg = _cfgs("mistral_nemo_12b")
    key = jax.random.PRNGKey(5)
    jp = JL.init_mlp(key, jcfg)
    table = JL.init_embed(key, jcfg)
    head = JL.init_unembed(key, jcfg)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 5, tcfg.d_model)).astype(np.float32)
    np.testing.assert_allclose(
        TL.mlp(_t(jp), torch.from_numpy(x)).numpy(),
        np.asarray(JL.mlp(jp, jnp.asarray(x))), **TOL)
    tok = rng.integers(0, tcfg.vocab_size, (2, 5))
    np.testing.assert_array_equal(
        TL.embed(_t(table), torch.from_numpy(tok)).numpy(),
        np.asarray(JL.embed(table, jnp.asarray(tok))))
    got = TL.unembed_logits(_t(head), torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(
        got.numpy(), np.asarray(JL.unembed_logits(head, jnp.asarray(x))),
        **TOL)


@pytest.mark.parametrize("cf,tokens", [(1.25, 7), (0.5, 16), (1.25, 1)])
def test_moe_matches_reference(cf, tokens):
    """Routing, capacity and drops (cf 0.5 drops about half the pairs; one
    token gives capacity max(1, ...) = 1)."""
    jcfg, tcfg = _cfgs("granite_moe_1b", capacity_factor=cf)
    jp = JM.init_moe(jax.random.PRNGKey(7), jcfg)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, tokens, tcfg.d_model)).astype(np.float32)
    exp, exp_aux = JM._moe_dense(jp, jnp.asarray(x), jcfg)
    got, aux = TM.moe(_t(jp), torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), **TOL)
    np.testing.assert_allclose(float(aux), float(exp_aux), rtol=1e-6)
    xt = x.reshape(-1, tcfg.d_model)
    jg, ji, jaux = JM._route(jnp.asarray(xt), jp["router"],
                             tcfg.num_experts, tcfg.top_k)
    tg, ti, taux = TM.route(torch.from_numpy(xt), _t(jp)["router"],
                            tcfg.top_k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), **TOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)
    ids = rng.integers(0, 4, 40)
    np.testing.assert_array_equal(
        TM.positions_in_bucket(torch.from_numpy(ids)).numpy(),
        np.asarray(JM._positions_in_bucket(jnp.asarray(ids), 4)))


@pytest.mark.parametrize("n,buckets", [(1, 4), (33, 1), (4096, 32)])
def test_positions_in_bucket_matches_reference(n, buckets):
    """Token-major rank in each bucket, as the reference's one-hot cumsum
    gives it (at 4096 x 32 some buckets hold hundreds, one may be empty)."""
    ids = np.random.default_rng(n).integers(0, buckets, n)
    np.testing.assert_array_equal(
        TM.positions_in_bucket(torch.from_numpy(ids)).numpy(),
        np.asarray(JM._positions_in_bucket(jnp.asarray(ids), buckets)))


def test_moe_router_stays_f32_in_bf16():
    cfg = dataclasses.replace(reduced(get_config("granite_moe_1b")),
                              dtype=torch.bfloat16)
    p = TM.init_moe(torch.Generator().manual_seed(0), cfg)
    assert p["router"].dtype == torch.float32
    assert p["wi"].dtype == torch.bfloat16


def test_reference_flash_path_with_longer_cache_vs_port():
    """The reference's flash path gets the whole cache and aligns its causal
    mask at the cache's end, so with a cache longer than the prompt its
    queries see empty slots; the port's flash path (the filled prefix only)
    equals the reference's XLA answer.  Prompt 20, cache 28."""
    jcfg, tcfg, jp, tp = _attn_setup("mistral_nemo_12b", 0)
    x = np.random.default_rng(0).standard_normal(
        (2, 20, tcfg.d_model)).astype(np.float32)
    kv, hd = tcfg.num_kv_heads, tcfg.head_dim

    def jcache(n):
        return {"k": jnp.zeros((2, kv, n, hd)), "v": jnp.zeros((2, kv, n, hd)),
                "idx": jnp.int32(0)}

    jflash = dataclasses.replace(jcfg, attn_impl="flash")
    exp, _ = JL.attention(jp, jnp.asarray(x), jcfg, cache=jcache(28))
    wrong, _ = JL.attention(jp, jnp.asarray(x), jflash, cache=jcache(28))
    right, _ = JL.attention(jp, jnp.asarray(x), jflash, cache=jcache(20))
    assert float(jnp.abs(wrong - exp).max()) > 1.0
    assert float(jnp.abs(right - exp).max()) < 1e-5
    got, _ = TL.attention(tp, torch.from_numpy(x),
                          dataclasses.replace(tcfg, attn_impl="flash"),
                          cache={"k": torch.zeros((2, kv, 28, hd)),
                                 "v": torch.zeros((2, kv, 28, hd)),
                                 "idx": 0})
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), **TOL)
