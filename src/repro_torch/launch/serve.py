"""Batched serving CLI: prefill, then greedy (or sampled) decode (port of
``repro.launch.serve``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite_moe_1b \\
        --batch 4 --prompt-len 32 --gen 16

Weights are random, drawn from a ``torch.Generator`` seeded 0 on the
serving device; prompts from one seeded 1; for the encoder-decoder (audio)
family, the frames [B, encoder_seq, d_model] that stand in for the audio
frontend's output from one seeded 2, as the reference draws them.  The
caches are kept in the parameters' dtype.  Prefill runs the flash kernel
on every attention layer; decode runs the chunked attention over the
cache.  ``--device`` defaults to ``cuda`` and raises where there is none;
``--device cpu`` runs the plain versions.  ``--ckpt-dir`` serves the
parameters of the latest checkpoint there (what ``launch/train.py``
saved, or the reference's ``repro.launch.train`` in its stacked layout),
read through the versioned store's double-collect validation onto the
serving device.  Serving runs under ``torch.no_grad()``.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import PORTED, get_config, reduced as make_reduced
from repro_torch.core.graph_state import resolve_device
from repro_torch.models import ModelConfig, get_model, param_shapes


@dataclasses.dataclass
class ServeResult:
    cfg: ModelConfig
    params: dict
    prompts: torch.Tensor          # [B, prompt_len] int64
    frames: Optional[torch.Tensor]  # [B, encoder_seq, d] f32 (encdec only)
    tokens: torch.Tensor           # [B, gen] generated, int64
    prefill_logits: torch.Tensor   # [B, 1, V] float32, the prompt's last
    last_logits: torch.Tensor      # [B, 1, V] of the last decode step
    prefill_s: float
    decode_s: float                # all gen - 1 decode steps
    peak_bytes: Optional[int]      # device memory high-water mark (CUDA)
    ckpt_step: Optional[int] = None  # the checkpoint's step (--ckpt-dir)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _next(logits: torch.Tensor, temperature: float,
          gen: torch.Generator) -> torch.Tensor:
    if temperature > 0:
        probs = torch.softmax(logits[:, -1] / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=gen)
    return torch.argmax(logits[:, -1], dim=-1)[:, None]


@torch.no_grad()
def serve(cfg: ModelConfig, *, batch: int, prompt_len: int, gen_len: int,
          temperature: float = 0.0, device="cuda", seed: int = 0,
          params: Optional[dict] = None) -> ServeResult:
    """Build the model (random weights from ``seed`` unless ``params`` are
    given), draw ``batch`` prompts, prefill them and decode ``gen_len``
    tokens (the first from the prefill's logits)."""
    dev = resolve_device(device)
    model = get_model(cfg)
    if params is None:
        params = model.init(torch.Generator(device=dev).manual_seed(seed))
    draw = torch.Generator(device=dev).manual_seed(seed + 1)
    prompts = torch.randint(1, cfg.vocab_size, (batch, prompt_len),
                            generator=draw, device=dev)
    extra = {}
    if cfg.family in ("encdec", "audio"):
        extra["frames"] = torch.randn(
            (batch, cfg.encoder_seq, cfg.d_model),
            generator=torch.Generator(device=dev).manual_seed(seed + 2),
            device=dev)
    cache = model.init_cache(batch, prompt_len + gen_len, dtype=cfg.dtype,
                             device=dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, prompts, cache, **extra)
    _sync(dev)
    prefill_s = time.perf_counter() - t0

    prefill_logits = logits
    toks = _next(logits, temperature, draw)
    out = [toks]
    t0 = time.perf_counter()
    for _ in range(gen_len - 1):
        logits, cache = model.decode_step(params, toks, cache)
        toks = _next(logits, temperature, draw)
        out.append(toks)
    _sync(dev)
    decode_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" \
        else None
    return ServeResult(cfg, params, prompts, extra.get("frames"),
                       torch.cat(out, dim=1),
                       prefill_logits, logits, prefill_s, decode_s, peak)


def main(argv=None) -> ServeResult:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite_moe_1b", choices=PORTED)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--ckpt-dir", default=None,
                    help="serve weights from a (possibly live) checkpoint")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without CUDA) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = make_reduced(cfg)
    params = step = None
    if args.ckpt_dir:
        step, restored = Checkpointer(args.ckpt_dir).restore_latest(
            {"params": param_shapes(get_model(cfg))}, device=args.device)
        if restored is not None:
            params = restored["params"]
            print(f"[serve] loaded validated snapshot @ step {step}")
    r = serve(cfg, batch=args.batch, prompt_len=args.prompt_len,
              gen_len=args.gen, temperature=args.temperature,
              device=args.device, params=params)
    r.ckpt_step = step
    steps = max(args.gen - 1, 1)
    print(f"[serve] {cfg.name} on {args.device}: prefill {args.prompt_len} "
          f"toks x{args.batch}: {r.prefill_s * 1e3:.1f} ms; decode "
          f"{args.gen - 1} steps: {r.decode_s / steps * 1e3:.1f} ms/tok "
          f"({args.batch * (args.gen - 1) / max(r.decode_s, 1e-9):.1f} "
          f"tokens/s)")
    for i in range(min(args.batch, 2)):
        print(f"  seq{i}: {r.tokens[i][:12].tolist()} ...")
    return r


if __name__ == "__main__":
    main()
