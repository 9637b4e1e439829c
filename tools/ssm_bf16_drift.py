#!/usr/bin/env python3
"""How far the bf16 forward of the random-init Mamba2 stack drifts from its
own float32 forward, layer by layer, on one NVIDIA GPU.

    python3 tools/ssm_bf16_drift.py

Draws ``chip_smoke.py`` phase 3h's mamba2_780m (seed 0 weights, LM_BATCH x
LM_PROMPT prompts from seed 1) and runs its 48 layers twice side by side:
in bf16, and in float32 on float32 copies of the same weights.  After every
fourth layer it prints the float32 hidden state's rms, the relative L2
distance of the bf16 stream from the float32 one, and that of one bf16
layer fed the float32 stream's own input (the rounding a single layer
adds).  Then the relative L2 distance between the logits of two bf16
prefills that differ only in the SSD chunk (64 against the config's 128).
Needs CUDA and exits nonzero without it.
"""
import dataclasses
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        sys.exit("ssm_bf16_drift: torch.cuda.is_available() is false")
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import chip_smoke as smoke
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    from repro_torch.models import layers as L
    from repro_torch.models import ssm as S

    torch.backends.cuda.matmul.allow_tf32 = False
    print("nvidia-smi:", subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    cfg = get_config("mamba2_780m")
    params = get_model(cfg).init(
        torch.Generator(device="cuda").manual_seed(0))
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    p32 = smoke.to_float32(torch, params)
    toks = torch.randint(1, cfg.vocab_size, (smoke.LM_BATCH, smoke.LM_PROMPT),
                         generator=torch.Generator(device="cuda").manual_seed(1),
                         device="cuda")

    def rel(a, b):
        return smoke.rel_l2(torch, a, b)

    with torch.no_grad():
        hb = L.embed(params["embed"], toks)
        hf = L.embed(p32["embed"], toks)
        for i, (lb, lf) in enumerate(zip(params["layers"], p32["layers"])):
            one = S.residual_block(lb, hf.to(cfg.dtype), cfg)
            hb = S.residual_block(lb, hb, cfg)
            hf = S.residual_block(lf, hf, cfg32)
            if i % 4 == 0 or i == cfg.num_layers - 1:
                print(f"layer {i:2d}: rms {float(hf.pow(2).mean().sqrt()):.3g}"
                      f", bf16 stream vs float32 {rel(hb, hf):.3g}, one bf16 "
                      f"layer on the float32 input {rel(one, hf):.3g}",
                      flush=True)
        logits = {}
        for chunk in (cfg.ssm_chunk, 64):
            c = dataclasses.replace(cfg, ssm_chunk=chunk)
            m = get_model(c)
            logits[chunk], _ = m.prefill(
                params, toks, m.init_cache(smoke.LM_BATCH, smoke.LM_PROMPT,
                                           dtype=cfg.dtype))
        print(f"bf16 prefill logits, chunk 64 vs {cfg.ssm_chunk}: rel L2 "
              f"{rel(logits[64], logits[cfg.ssm_chunk]):.3g}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
