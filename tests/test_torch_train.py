"""Training in the port against the reference on the CPU.

Every family's ``loss_fn`` and its gradients against
``jax.value_and_grad(model.loss_fn)`` on reduced configs (f32), the
reference's parameters carried over with ``params_from_jax``: the loss to
rtol 1e-5, every gradient leaf to rtol = atol = 1e-4 (the SSD's own
gradients are held in ``tests/test_torch_ssm.py``).  Then the port's own
machinery: the trainer CLI and a serve from its
checkpoint, ``RestartableLoop``'s resume, the chunked random init and the
flash kernel's plain version under autograd.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config, reduced as jax_reduced
from repro.models import get_model as jax_model
from repro_torch.checkpoint import latest_step
from repro_torch.configs import get_config, reduced
from repro_torch.launch import serve, steps, train
from repro_torch.models import get_model, layers as TL
from repro_torch.models.convert import params_from_jax
from repro_torch.optim.tree import tree_leaves
from repro_torch.runtime import RestartableLoop

ARCHS = ["mistral_nemo_12b", "granite_moe_1b", "qwen2_vl_72b", "mamba2_780m",
         "zamba2_12b", "whisper_large_v3", "gemma3_27b",
         "llama4_maverick_400b"]
B, SEQ = 2, 21
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)


def _batch(cfg, seed=0):
    """Tokens [B, SEQ] with some 0s (masked targets), M-RoPE positions and
    Whisper's frames where the family takes them."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, SEQ)).astype(
        np.int32)}
    if cfg.mrope_sections:
        out["positions"] = rng.integers(0, SEQ, (3, B, SEQ - 1)).astype(
            np.int32)
    if cfg.encoder_seq:
        out["frames"] = rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch):
    """Windows (gemma3: 16, local only at 4 layers), top-1 routing (llama4),
    top-2 with the load-balance term (granite), M-RoPE (qwen2_vl), the SSD
    over two chunks (mamba2, zamba2), cross-attention (whisper)."""
    jcfg = jax_reduced(jax_config(arch))
    jm = jax_model(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    batch = _batch(jcfg)
    jloss, jgrads = jax.jit(jax.value_and_grad(jm.loss_fn))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})

    cfg = dataclasses.replace(reduced(get_config(arch)), attn_impl="xla")
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    loss, grads = steps.value_and_grad(
        get_model(cfg).loss_fn, params,
        {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    exp = tree_leaves(params_from_jax(jax.tree.map(np.asarray, jgrads),
                                      device="cpu"))
    got = tree_leaves(grads)
    assert len(got) == len(exp)
    for g, e in zip(got, exp):
        assert g.shape == e.shape and g.dtype == e.dtype
        np.testing.assert_allclose(g.numpy(), e.numpy(), **GRAD_TOL)


def test_remat_does_not_change_the_gradients():
    """``cfg.remat`` (checkpointed layers, chunks of the attention and of the
    cross-entropy) recomputes the same forward: equal loss and gradients."""
    cfg = dataclasses.replace(reduced(get_config("granite_moe_1b")),
                              attn_impl="xla", attn_chunk=8, xent_chunk=8)
    params = get_model(cfg).init(torch.Generator().manual_seed(3))
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, 4).items()}
    out = [steps.value_and_grad(
        get_model(dataclasses.replace(cfg, remat=r)).loss_fn, params, batch)
        for r in (False, True)]
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(tree_leaves(out[0][1]), tree_leaves(out[1][1])):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_train_main_then_serve_from_its_checkpoint(tmp_path, capsys):
    """The trainer CLI at a reduced size: finite losses, checkpoints at
    every --ckpt-every and at the end; serve --ckpt-dir serves exactly
    the trained parameters; a second run with more steps resumes."""
    d = str(tmp_path / "ckpt")
    args = ["--arch", "granite_moe_1b", "--reduced", "--device", "cpu",
            "--batch", "2", "--seq", "32", "--ckpt-dir", d,
            "--ckpt-every", "2", "--log-every", "1"]
    r = train.main([*args, "--steps", "5"])
    out = capsys.readouterr().out
    assert "[train]" in out and "step     4" in out
    assert r.start_step == 0 and len(r.losses) == 5
    assert all(np.isfinite(r.losses)) and r.peak_bytes is None
    assert r.cfg.attn_impl == "xla" and r.cfg.remat
    assert int(r.opt.step) == 5 and latest_step(d) == 5
    assert r.lrs[0] == 0.0 and r.lrs[2] == pytest.approx(3e-4)

    s = serve.main(["--arch", "granite_moe_1b", "--reduced", "--device",
                    "cpu", "--batch", "2", "--prompt-len", "9", "--gen", "3",
                    "--ckpt-dir", d])
    assert s.ckpt_step == 5
    for got, exp in zip(tree_leaves(s.params), tree_leaves(r.params)):
        assert torch.equal(got, exp)
    mem = serve.serve(reduced(get_config("granite_moe_1b")), batch=2,
                      prompt_len=9, gen_len=3, device="cpu", params=r.params)
    assert torch.equal(s.prefill_logits, mem.prefill_logits)
    assert torch.equal(s.tokens, mem.tokens)

    r2 = train.main([*args, "--steps", "7"])
    assert r2.start_step == 5 and len(r2.losses) == 2
    assert int(r2.opt.step) == 7


def test_train_main_refuses_mesh_and_missing_cuda():
    # a mesh needs its processes: torchrun's environment or a DistMesh
    with pytest.raises(RuntimeError, match="torchrun"):
        train.main(["--reduced", "--device", "cpu", "--mesh", "single"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            train.main(["--reduced", "--steps", "1"])


def test_train_main_compress_grads_runs():
    r = train.main(["--arch", "mamba2_780m", "--reduced", "--device", "cpu",
                    "--batch", "2", "--seq", "24", "--steps", "3",
                    "--compress-grads"])
    assert len(r.losses) == 3 and all(np.isfinite(r.losses))


def _loop_setup():
    cfg = train.train_config("granite_moe_1b", reduced=True)
    model = get_model(cfg)
    from repro_torch.data import SyntheticTokens, shard_batch
    from repro_torch.optim import adamw_init

    ds = SyntheticTokens(cfg.vocab_size, 16, 2, seed=0)
    step_fn = train.make_train_step(model, 8, 3e-4)
    losses = {}

    def loop_step(state, step):
        p, o, m = step_fn(state["params"], state["opt"],
                          shard_batch(ds.batch_at(step), device="cpu"))
        losses.setdefault(step, []).append(float(m["loss"]))
        return {"params": p, "opt": o}

    params = model.init(torch.Generator().manual_seed(0))
    return {"params": params, "opt": adamw_init(params)}, loop_step, losses


def test_restartable_loop_resumes_training_exactly(tmp_path):
    """A crash at step 5 (checkpoints every 2): the rerun resumes from step
    4 and ends with the uninterrupted run's losses and parameters, bit for
    bit on the CPU."""
    state0, loop_step, losses = _loop_setup()
    ref, done = RestartableLoop(str(tmp_path / "a"), loop_step, state0,
                                ckpt_every=2, device="cpu").run(state0, 8)
    assert done == 8
    clean = {k: v[0] for k, v in losses.items()}
    losses.clear()
    d = str(tmp_path / "b")
    with pytest.raises(RuntimeError, match="injected failure at step 5"):
        RestartableLoop(d, loop_step, state0, ckpt_every=2,
                        device="cpu").run(state0, 8, fail_at=5)
    assert latest_step(d) == 4
    final, done = RestartableLoop(d, loop_step, state0, ckpt_every=2,
                                  device="cpu").run(state0, 8)
    assert done == 8 and sorted(losses) == list(range(8))
    assert [len(losses[s]) for s in range(8)] == [1] * 4 + [2] + [1] * 3
    assert {s: v[-1] for s, v in losses.items()} == clean
    for a, b in zip(tree_leaves(final), tree_leaves(ref)):
        assert torch.equal(a, b)


def test_restartable_loop_resumes_after_crash(tmp_path):
    """The reference's tests/test_checkpoint.py case, on the port."""
    calls = []

    def step_fn(state, step):
        calls.append(step)
        return {"x": state["x"] + 1}

    state0 = {"x": torch.zeros((), dtype=torch.float32)}
    loop = RestartableLoop(str(tmp_path), step_fn, state0, ckpt_every=5,
                           device="cpu")
    with pytest.raises(RuntimeError):
        loop.run(state0, total_steps=20, fail_at=12)
    assert latest_step(str(tmp_path)) == 10
    loop2 = RestartableLoop(str(tmp_path), step_fn, state0, ckpt_every=5,
                            device="cpu")
    final, done = loop2.run(state0, total_steps=20)
    assert done == 20
    assert float(final["x"]) == 20.0           # no lost or repeated steps
    assert calls.count(11) == 2                 # 11 replayed from ckpt 10
    assert calls.count(4) == 1                  # pre-ckpt steps not replayed


def test_init_draws_a_large_tensor_slice_by_slice(monkeypatch):
    """Above INIT_DRAW_BYTES a tensor is drawn in blocks of leading-axis
    slices: every float32 draw stays within the limit, and the result is
    those draws, scaled and cast, in order."""
    draws = []
    randn = torch.randn

    def spy(shape, **kw):
        draws.append(tuple(shape))
        return randn(shape, **kw)

    monkeypatch.setattr(TL, "INIT_DRAW_BYTES", 4 * 3 * 8 * 5)
    monkeypatch.setattr(torch, "randn", spy)
    got = TL._init(torch.Generator().manual_seed(9), (7, 8, 5),
                   torch.bfloat16)
    assert draws == [(3, 8, 5), (3, 8, 5), (1, 8, 5)]
    g = torch.Generator().manual_seed(9)
    exp = torch.cat([randn((n, 8, 5), generator=g) for n in (3, 3, 1)])
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, (exp * 8 ** -0.5).bfloat16())
    draws.clear()
    small = TL._init(torch.Generator().manual_seed(9), (3, 8, 5),
                     torch.float32)
    assert draws == [(3, 8, 5)] and small.shape == (3, 8, 5)


def test_flash_plain_version_differentiates_on_the_cpu():
    """On the CPU the kernel's plain version is differentiable; the CUDA
    kernel refuses autograd (tests/test_torch_cuda.py)."""
    from repro_torch.kernels import ops as kops

    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((1, 4, 8, 16), generator=g).requires_grad_()
               for _ in range(3))
    out = kops.flash_attention(q, k, v, causal=True)
    gq, = torch.autograd.grad(out.sum(), [q])
    assert gq.shape == q.shape and bool(torch.isfinite(gq).all())


@pytest.mark.parametrize("arch", ["qwen2_vl_72b", "whisper_large_v3"])
def test_prefill_and_decode_steps_match_reference(arch):
    """``build_prefill_step`` and ``build_decode_step`` against the
    reference's, jitted, on the same parameters and batches: the prefill
    and two decode steps' logits to rtol = atol = 1e-4, M-RoPE positions
    (qwen2_vl) and Whisper's frames passed through the batch dict, and the
    port's outputs made without autograd."""
    from repro.launch import steps as jax_steps

    jcfg = jax_reduced(jax_config(arch))
    jm = jax_model(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    cfg = dataclasses.replace(reduced(get_config(arch)), attn_impl="xla")
    model = get_model(cfg)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    for p in tree_leaves(params):
        p.requires_grad_()
    first = _batch(cfg, seed=5)           # positions cover SEQ - 1 inputs
    first["tokens"] = first["tokens"][:, :SEQ - 1]
    batches, rng = [first], np.random.default_rng(5)
    for i in range(2):
        nxt = {"tokens": rng.integers(1, cfg.vocab_size, (B, 1)).astype(
            np.int32)}
        if cfg.mrope_sections:
            nxt["positions"] = np.full((3, B, 1), SEQ - 1 + i, np.int32)
        batches.append(nxt)

    jpre = jax.jit(jax_steps.build_prefill_step(jm))
    jdec = jax.jit(jax_steps.build_decode_step(jm))
    tpre = steps.build_prefill_step(model)
    tdec = steps.build_decode_step(model)
    jc = jm.init_cache(B, SEQ + 4, dtype=jnp.float32)
    tc = model.init_cache(B, SEQ + 4, dtype=torch.float32, device="cpu")
    for i, batch in enumerate(batches):
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        tb = {k: torch.from_numpy(v).long() if v.dtype == np.int32
              else torch.from_numpy(v) for k, v in batch.items()}
        jl, jc = (jpre if i == 0 else jdec)(jparams, jc, jb)
        tl, tc = (tpre if i == 0 else tdec)(params, tc, tb)
        assert not tl.requires_grad
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **GRAD_TOL,
                                   err_msg=f"{arch} step {i}")
