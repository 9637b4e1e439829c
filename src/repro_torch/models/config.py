"""Model configuration shared by every architecture (port of
``repro.models.config``).

The same fields as the reference, with torch dtypes.  One default differs:
``attn_impl`` is ``"flash"``, the reference's TPU path -- prefill attention
goes through the hand-written kernel (``repro_torch.kernels.flash_attention``).
``"xla"`` selects the port of the reference's chunked attention
(``layers.sdpa_chunked``), which the tests and ``chip_smoke.py`` use as an
independent second path.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | vlm | ssm | hybrid | encdec
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # attention
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    window: Optional[int] = None       # sliding window for local layers
    local_global: int = 0              # N => N local layers : 1 global layer
    mrope_sections: Optional[Tuple[int, int, int]] = None  # M-RoPE (VLM)

    # MoE
    num_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25

    # SSM (Mamba2 SSD)
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    conv_kernel: int = 4

    # hybrid (Zamba2): a weight-shared attention block every `attn_every` layers
    attn_every: int = 0

    # encoder-decoder (Whisper): encoder depth and fixed frame count
    encoder_layers: int = 0
    encoder_seq: int = 0

    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    logit_softcap: float = 0.0
    dtype: torch.dtype = torch.bfloat16
    moment_dtype: torch.dtype = torch.float32  # optimizer moments

    # training-time knobs (kept so configs carry over field for field)
    xent_chunk: int = 512              # chunked cross-entropy block
    attn_chunk: int = 512              # q-block of the chunked attention
    remat: bool = True
    # "flash": prefill through the hand-written kernel; "xla": the port of
    # the reference's chunked attention.
    attn_impl: str = "flash"
    scan_unroll: bool = False

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    def params_dense(self) -> int:
        """Approximate parameter count (for 6ND roofline math)."""
        d, ff, L, V = self.d_model, self.d_ff, self.num_layers, self.vocab_size
        h = self.num_heads * self.head_dim
        kv = self.num_kv_heads * self.head_dim
        attn = d * h + 2 * d * kv + h * d
        if self.family in ("ssm", "hybrid"):
            blk = self._ssm_block_params()
        elif self.family == "moe":
            blk = attn + 3 * d * ff * self.num_experts
        else:
            blk = attn + 3 * d * ff
        total = L * blk + V * d
        if self.family == "hybrid" and self.attn_every:
            total += attn + 3 * d * self.d_ff     # one shared block
        if self.family == "encdec":
            enc_blk = attn + 3 * d * ff
            total += self.encoder_layers * enc_blk + L * attn  # cross-attn
        return total

    def params_active(self) -> int:
        """Active parameters per token (MoE-aware)."""
        if self.family != "moe":
            return self.params_dense()
        d, ff, L, V = self.d_model, self.d_ff, self.num_layers, self.vocab_size
        h = self.num_heads * self.head_dim
        kv = self.num_kv_heads * self.head_dim
        attn = d * h + 2 * d * kv + h * d
        blk = attn + 3 * d * ff * max(1, self.top_k)
        return L * blk + V * d

    def _ssm_block_params(self) -> int:
        d, di, n = self.d_model, self.d_inner, self.ssm_state
        h = self.ssm_heads
        in_p = d * (2 * di + 2 * n + h)  # zx + B,C + dt heads (grouped B/C)
        return in_p + di * d + di * self.conv_kernel
