"""The port's serving entry point (``repro_torch.launch.serve``) on the CPU.

It runs end to end at a reduced size, its greedy tokens equal a greedy loop
over the reference's ``prefill``/``decode_step`` on the same weights and
prompts, it serves a checkpoint's parameters (``--ckpt-dir``) under
``no_grad``, and without CUDA its default device raises.
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
from repro_torch.launch import serve
from repro_torch.models import get_model
from repro_torch.models.convert import params_from_jax
from repro_torch.optim.tree import tree_map

ARGS = ["--reduced", "--device", "cpu", "--batch", "2", "--prompt-len", "9",
        "--gen", "5"]


@pytest.mark.parametrize("arch", ["granite_moe_1b", "mistral_nemo_12b",
                                  "mamba2_780m", "zamba2_12b",
                                  "whisper_large_v3"])
def test_main_runs_reduced_on_cpu(arch, capsys):
    r = serve.main(["--arch", arch, *ARGS])
    assert "[serve]" in capsys.readouterr().out
    assert r.tokens.shape == (2, 5) and r.prompts.shape == (2, 9)
    if r.cfg.family == "audio":  # frames from a generator seeded 0 + 2
        exp = torch.randn((2, r.cfg.encoder_seq, r.cfg.d_model),
                          generator=torch.Generator().manual_seed(2))
        assert torch.equal(r.frames, exp)
    else:
        assert r.frames is None
    assert int(r.tokens.min()) >= 0 and int(r.tokens.max()) < 256
    assert r.prefill_logits.shape == (2, 1, 256)
    assert bool(torch.isfinite(r.last_logits).all())
    assert r.peak_bytes is None  # no device memory on the CPU


@pytest.mark.parametrize("arch", ["granite_moe_1b", "qwen3_32b",
                                  "mamba2_780m", "zamba2_12b",
                                  "whisper_large_v3"])
def test_greedy_tokens_match_reference(arch):
    jcfg = jax_reduced(jax_config(arch))
    jm = jax_model(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    r = serve.serve(reduced(get_config(arch)), batch=2, prompt_len=9,
                    gen_len=5, device="cpu", params=params)
    cache = jm.init_cache(2, 14, dtype=jnp.float32)
    extra = {} if r.frames is None else {
        "frames": jnp.asarray(r.frames.numpy())}
    logits, cache = jax.jit(lambda p, t, c, kw: jm.prefill(p, t, c, **kw))(
        jparams, jnp.asarray(r.prompts.numpy()), cache, extra)
    np.testing.assert_allclose(r.prefill_logits.numpy(), np.asarray(logits),
                               rtol=1e-4, atol=1e-4)
    decode = jax.jit(jm.decode_step)
    toks = [jnp.argmax(logits[:, -1], axis=-1)[:, None]]
    for _ in range(4):
        logits, cache = decode(jparams, toks[-1], cache)
        toks.append(jnp.argmax(logits[:, -1], axis=-1)[:, None])
    np.testing.assert_array_equal(r.tokens.numpy(),
                                  np.asarray(jnp.concatenate(toks, axis=1)))
    np.testing.assert_allclose(r.last_logits.numpy(), np.asarray(logits),
                               rtol=1e-4, atol=1e-4)


def test_sampling_and_cache_dtype():
    cfg = dataclasses.replace(reduced(get_config("granite_moe_1b")),
                              dtype=torch.bfloat16)
    r = serve.serve(cfg, batch=2, prompt_len=6, gen_len=3, temperature=0.8,
                    device="cpu")
    assert r.tokens.shape == (2, 3)
    assert int(r.tokens.max()) < cfg.vocab_size


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here: the default device works")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--reduced"])


def test_ckpt_dir_round_trip(tmp_path):
    """--ckpt-dir serves the latest checkpoint's parameters exactly: the
    logits and tokens of serving them from memory.  Its bf16 leaves come
    back into the reduced (f32) model as their exact values.  An empty
    directory serves the seed's random weights."""
    from repro_torch.checkpoint import Checkpointer

    cfg = reduced(get_config("granite_moe_1b"))
    params = get_model(cfg).init(torch.Generator().manual_seed(5))
    half = tree_map(lambda t: t.bfloat16(), params)
    ck = Checkpointer(str(tmp_path))
    ck.save(3, {"params": params})
    ck.save(7, {"params": half})
    ck.wait()
    r = serve.main([*ARGS, "--ckpt-dir", str(tmp_path)])
    assert r.ckpt_step == 7
    mem = serve.serve(cfg, batch=2, prompt_len=9, gen_len=5, device="cpu",
                      params=tree_map(lambda t: t.float(), half))
    assert torch.equal(r.prefill_logits, mem.prefill_logits)
    assert torch.equal(r.tokens, mem.tokens)
    empty = serve.main([*ARGS, "--ckpt-dir", str(tmp_path / "none")])
    assert empty.ckpt_step is None
    assert torch.equal(empty.prefill_logits, serve.main(ARGS).prefill_logits)


def test_serve_runs_without_autograd():
    """Parameters that require grad (fresh from training) serve under
    no_grad: no graph is built, and on the card the flash kernel's guard
    is not tripped."""
    cfg = reduced(get_config("mistral_nemo_12b"))
    params = tree_map(lambda t: t.requires_grad_(),
                      get_model(cfg).init(torch.Generator().manual_seed(1)))
    r = serve.serve(cfg, batch=2, prompt_len=6, gen_len=3, device="cpu",
                    params=params)
    for t in (r.prefill_logits, r.last_logits):
        assert not t.requires_grad and t.grad_fn is None
