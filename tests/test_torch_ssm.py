"""The port's Mamba2 SSD pieces (``repro_torch.models.ssm``) against the
reference's (``repro.models.ssm``) on the CPU, on the same seeded numpy
inputs: ``ssd_chunked`` at prompt lengths that are and are not a multiple
of the chunk (dt = 0 padding), with and without a carried state;
``_causal_conv`` with and without its history; ``mamba_block`` prefill then
decode steps (the chunked form, then the one-step recurrence).  Float32 to
1e-5.  Then the port's own identities, as the reference's
``tests/test_models_smoke.py`` checks them: the output does not depend on
the chunk, and the chunked final state equals the step-by-step recurrence.
A bf16 case checks that the port rounds where the reference does.  Under
autograd, the gradients of ``ssd_chunked`` and ``mamba_block`` against the
reference's VJP (rtol = atol = 1e-4).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config, reduced as jax_reduced
from repro.models import ssm as JS
from repro_torch.configs import get_config, reduced
from repro_torch.models import layers as TL
from repro_torch.models import ssm as TS

TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)


def _ssd_inputs(seed, b, s, h, p, n, state=False):
    rng = np.random.default_rng(seed)
    out = dict(
        x=rng.standard_normal((b, s, h, p)).astype(np.float32),
        dt=(rng.random((b, s, h)) * 0.5 + 0.1).astype(np.float32),
        a=-(rng.random((h,)) * 0.5 + 0.2).astype(np.float32),
        bm=rng.standard_normal((b, s, n)).astype(np.float32),
        cm=rng.standard_normal((b, s, n)).astype(np.float32))
    if state:
        out["init_state"] = rng.standard_normal((b, h, p, n)).astype(
            np.float32)
    return out


def _jax(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def _torch(d):
    return {k: torch.from_numpy(v) for k, v in d.items()}


@pytest.mark.parametrize("s", [32, 37, 5])
@pytest.mark.parametrize("state", [False, True])
def test_ssd_chunked_matches_reference(s, state):
    """Chunk 16: two whole chunks (32), three with 11 rows of dt = 0
    padding (37), and one chunk shorter than 16 (5)."""
    d = _ssd_inputs(s, 2, s, 3, 8, 16, state)
    ey, ef = JS.ssd_chunked(**_jax(d), chunk=16)
    gy, gf = TS.ssd_chunked(**_torch(d), chunk=16)
    assert tuple(gy.shape) == (2, s, 3, 8) and tuple(gf.shape) == (2, 3, 8, 16)
    np.testing.assert_allclose(gy.numpy(), np.asarray(ey), **TOL)
    np.testing.assert_allclose(gf.numpy(), np.asarray(ef), **TOL)


def test_ssd_chunked_bf16_rounds_as_reference():
    """bf16 activations, float32 dt and decays, a bf16 carried state: the
    same output dtypes as the reference, and values within a bf16 rounding
    or two (the two packages sum their products in other orders)."""
    d = _ssd_inputs(3, 2, 37, 3, 8, 16, state=True)
    bf = ("x", "bm", "cm", "init_state")
    jd = {k: jnp.asarray(v, jnp.bfloat16 if k in bf else jnp.float32)
          for k, v in d.items()}
    td = {k: torch.from_numpy(v).to(torch.bfloat16 if k in bf
                                    else torch.float32)
          for k, v in d.items()}
    ey, ef = JS.ssd_chunked(**jd, chunk=16)
    gy, gf = TS.ssd_chunked(**td, chunk=16)
    assert gy.dtype == torch.bfloat16 and str(ey.dtype) == "bfloat16"
    assert gf.dtype == torch.bfloat16 and str(ef.dtype) == "bfloat16"
    for got, exp in ((gy, ey), (gf, ef)):
        exp = np.asarray(exp.astype(jnp.float32))
        got = got.float().numpy()
        assert np.linalg.norm(got - exp) / np.linalg.norm(exp) < 1e-2


@pytest.mark.parametrize("history", [False, True])
def test_causal_conv_matches_reference(history):
    rng = np.random.default_rng(4)
    xbc = rng.standard_normal((2, 9, 12)).astype(np.float32)
    w = rng.standard_normal((12, 4)).astype(np.float32)
    b = rng.standard_normal((12,)).astype(np.float32)
    hist = rng.standard_normal((2, 3, 12)).astype(np.float32) \
        if history else None
    eo, ec = JS._causal_conv(jnp.asarray(xbc), jnp.asarray(w),
                             jnp.asarray(b),
                             None if hist is None else jnp.asarray(hist))
    go, gc = TS._causal_conv(torch.from_numpy(xbc), torch.from_numpy(w),
                             torch.from_numpy(b),
                             None if hist is None else torch.from_numpy(hist))
    np.testing.assert_allclose(go.numpy(), np.asarray(eo), **TOL)
    if history:
        np.testing.assert_allclose(gc.numpy(), np.asarray(ec), **TOL)
    else:
        assert gc is None and ec is None


def _block_setup(seed=0):
    jcfg = jax_reduced(jax_config("mamba2_780m"))
    tcfg = reduced(get_config("mamba2_780m"))
    jp = JS.init_ssm_block(jax.random.PRNGKey(seed), jcfg)
    # A_log, dt_bias and D start at 0, 0 and 1: draw them so the test
    # reaches their terms.
    rng = np.random.default_rng(seed)
    h = jcfg.ssm_heads
    jp = dict(jp, A_log=jnp.asarray(rng.standard_normal(h) * 0.5, jnp.float32),
              dt_bias=jnp.asarray(rng.standard_normal(h) * 0.5, jnp.float32),
              D=jnp.asarray(rng.standard_normal(h), jnp.float32),
              conv_b=jnp.asarray(rng.standard_normal(TS.conv_dim(tcfg)),
                                 jnp.float32))
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    return jcfg, tcfg, jp, tp


def test_mamba_block_without_cache_matches_reference():
    jcfg, tcfg, jp, tp = _block_setup(1)
    x = np.random.default_rng(5).standard_normal(
        (2, 37, tcfg.d_model)).astype(np.float32)
    exp, enc = JS.mamba_block(jp, jnp.asarray(x), jcfg)
    got, gnc = TS.mamba_block(tp, torch.from_numpy(x), tcfg)
    assert gnc is None and enc is None
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), **TOL)


def test_mamba_block_prefill_then_decode_matches_reference():
    """Prefill 37 tokens (three chunks of 16, the last padded) into a zero
    cache, then four one-token decode steps through the recurrence."""
    jcfg, tcfg, jp, tp = _block_setup(2)
    rng = np.random.default_rng(6)
    jc = JS.init_ssm_cache(jcfg, 2, dtype=jnp.float32)
    tc = {k: torch.from_numpy(np.array(v)) for k, v in jc.items()}
    for n in (37, 1, 1, 1, 1):
        x = rng.standard_normal((2, n, tcfg.d_model)).astype(np.float32)
        exp, jc = JS.mamba_block(jp, jnp.asarray(x), jcfg, jc)
        got, tc = TS.mamba_block(tp, torch.from_numpy(x), tcfg, tc)
        np.testing.assert_allclose(got.numpy(), np.asarray(exp), **TOL)
        for key in ("conv", "ssd"):
            np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]),
                                       **TOL)


def test_residual_block_writes_the_cache_in_place():
    jcfg, tcfg, jp, tp = _block_setup(3)
    cache = TS.init_ssm_cache(tcfg, 2, dtype=torch.float32, device="cpu",
                              lead=(3,))
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (2, 20, tcfg.d_model)).astype(np.float32))
    lp = {"mixer": tp, "ln": torch.ones(tcfg.d_model)}
    out = TS.residual_block(lp, x, tcfg, TS.layer_cache(cache, 1))
    exp, nc = TS.mamba_block(tp, TL.rms_norm(x, lp["ln"], tcfg.norm_eps),
                             tcfg, TS.init_ssm_cache(tcfg, 2, torch.float32,
                                                     "cpu"))
    torch.testing.assert_close(out, x + exp, rtol=0, atol=0)
    for key in ("conv", "ssd"):
        torch.testing.assert_close(cache[key][1], nc[key], rtol=0, atol=0)
        assert not cache[key][0].any() and not cache[key][2].any()


def test_ssd_chunk_invariance():
    """The output does not depend on the chunk (an algebraic identity)."""
    d = _torch(_ssd_inputs(0, 2, 24, 2, 4, 8))
    y1, f1 = TS.ssd_chunked(**d, chunk=4)
    for chunk in (24, 7):   # one chunk; a chunk that does not divide 24
        y2, f2 = TS.ssd_chunked(**d, chunk=chunk)
        torch.testing.assert_close(y2, y1, rtol=0, atol=1e-4)
        torch.testing.assert_close(f2, f1, rtol=0, atol=1e-4)


@pytest.mark.parametrize("state", [False, True])
def test_ssd_state_carry_matches_recurrence(state):
    """The chunked final state and output equal the step-by-step decode
    recurrence of ``mamba_block`` (numpy, float64)."""
    d = _ssd_inputs(1, 1, 12, 2, 4, 6, state)
    y, final = TS.ssd_chunked(**_torch(d), chunk=4)
    h = d["init_state"].astype(np.float64) if state else np.zeros(
        (1, 2, 4, 6))
    ys = []
    for t in range(12):
        da = np.exp(d["dt"][:, t] * d["a"][None])                 # [b,h]
        upd = np.einsum("bn,bh,bhp->bhpn", d["bm"][:, t], d["dt"][:, t],
                        d["x"][:, t])
        h = da[:, :, None, None] * h + upd
        ys.append(np.einsum("bn,bhpn->bhp", d["cm"][:, t], h))
    np.testing.assert_allclose(final.numpy(), h, rtol=0, atol=1e-4)
    np.testing.assert_allclose(y.numpy(), np.stack(ys, axis=1), rtol=0,
                               atol=1e-4)


def test_reduced_config_matches_reference():
    t, j = reduced(get_config("mamba2_780m")), jax_reduced(
        jax_config("mamba2_780m"))
    for f in dataclasses.fields(j):
        if f.name not in ("dtype", "moment_dtype", "attn_impl"):
            assert getattr(t, f.name) == getattr(j, f.name), f.name
    assert t.ssm_chunk == 16 and TS.conv_dim(t) == 2 * t.d_model + 32


def _vjp_check(jfn, tfn, inputs, cot_seed):
    """The port's gradients of <tfn(inputs)[0], cot> against the
    reference's VJP of jfn with the same cotangent."""
    jout, vjp = jax.vjp(jfn, *(jnp.asarray(v) for v in inputs))
    cot = np.random.default_rng(cot_seed).standard_normal(
        jout[0].shape).astype(np.float32)
    exp = vjp((jnp.asarray(cot), jnp.zeros_like(jout[1])))
    leaves = [torch.from_numpy(v).requires_grad_() for v in inputs]
    out = tfn(*leaves)
    np.testing.assert_allclose(out[0].detach().numpy(), np.asarray(jout[0]),
                               rtol=1e-5, atol=1e-5)
    got = torch.autograd.grad((out[0] * torch.from_numpy(cot)).sum(), leaves)
    for g, e in zip(got, exp):
        np.testing.assert_allclose(g.numpy(), np.asarray(e), **GRAD_TOL)


@pytest.mark.parametrize("s", [32, 37])
def test_ssd_chunked_grads_match_reference(s):
    """The out-of-place masked exp: autograd through the intra-chunk term
    (the serving form works in place and cannot be differentiated)."""
    rng = np.random.default_rng(s)
    b, h, p, n = 2, 3, 8, 16
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = (rng.random((b, s, h)) * 0.5 + 0.1).astype(np.float32)
    a = -(rng.random((h,)) * 0.5 + 0.2).astype(np.float32)
    bm = rng.standard_normal((b, s, n)).astype(np.float32)
    cm = rng.standard_normal((b, s, n)).astype(np.float32)
    _vjp_check(lambda *t: JS.ssd_chunked(*t, chunk=16),
               lambda *t: TS.ssd_chunked(*t, chunk=16),
               [x, dt, a, bm, cm], 1)


def test_mamba_block_grads_match_reference():
    jcfg, cfg, jp, _ = _block_setup(2)
    names = sorted(jp)
    x = np.random.default_rng(6).standard_normal(
        (2, 21, cfg.d_model)).astype(np.float32)
    inputs = [x] + [np.array(jp[k]) for k in names]

    def jfn(x, *ps):
        out, _ = JS.mamba_block(dict(zip(names, ps)), x, jcfg)
        return out, jnp.zeros(())

    def tfn(x, *ps):
        out, _ = TS.mamba_block(dict(zip(names, ps)), x, cfg)
        return out, None

    _vjp_check(jfn, tfn, inputs, 3)
