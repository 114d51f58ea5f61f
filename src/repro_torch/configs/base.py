"""Architecture configuration schema + input-shape cells (LM substrate).

A verbatim copy of the reference's ``configs/base.py`` (pure Python and
numpy): every architecture is a frozen :class:`ArchConfig`, the input-shape
cells are :data:`SHAPES`, and ``reduced()`` derives the small same-family
variant the CPU tests run.  The port keeps its own copy so that it imports
nothing of the reference package.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["ArchConfig", "ShapeCell", "SHAPES", "GLOBAL_WINDOW"]

GLOBAL_WINDOW = 0            # sentinel in window patterns: full attention
_BIG_WINDOW = 1 << 30


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                # 0 -> d_model // n_heads
    block: str = "dense"             # dense | moe | rwkv | hymba
    # attention / block details
    act: str = "silu"
    gated: bool = True
    qkv_bias: bool = False
    qk_norm: bool = False
    attn_softcap: float | None = None
    logit_softcap: float | None = None
    rope_theta: float = 10000.0
    windows: tuple[int, ...] | None = None   # repeating pattern; 0 = global
    sandwich_norm: bool = False              # gemma2 pre+post norms
    norm: str = "rms"                        # rms | layernorm
    norm_eps: float = 1e-6
    pos_emb: str = "rope"                    # rope | learned
    scale_embed: bool = False                # gemma-style sqrt(d) embed scale
    tie_embeddings: bool = False
    # moe
    n_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    dense_residual: bool = False             # arctic parallel dense FFN
    capacity_factor: float = 1.25
    # ssm / hybrid
    ssm_state: int = 0
    # encoder-decoder (whisper): n_layers = decoder layers
    enc_layers: int = 0
    audio_ctx: int = 0
    # vlm (llava): stub patch embeddings prepended to the text sequence
    img_tokens: int = 0
    # training / compute
    remat: bool = True
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    opt_moment_dtype: str = "float32"        # bf16 for the >100B archs
    use_kernels: bool = False                # Pallas paths (TPU / interpret)
    attn_impl: str = "chunked"               # naive | chunked | flash
    # provenance
    source: str = ""

    # ------------------------------------------------------------------
    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def layer_windows(self) -> np.ndarray:
        """Per-layer attention windows, (n_layers,) int32; global -> 2^30."""
        if self.windows is None:
            w = [GLOBAL_WINDOW] * self.n_layers
        else:
            w = [self.windows[i % len(self.windows)]
                 for i in range(self.n_layers)]
        return np.asarray([_BIG_WINDOW if x == GLOBAL_WINDOW else x
                           for x in w], np.int32)

    def window_pattern(self) -> tuple:
        """Static per-sublayer windows (None = global), length = the pattern
        period p, with p | n_layers.  The layer scan runs over n_layers/p
        *groups* whose body unrolls p sub-layers, so every attention call
        sees a **static** window and the banded block-skipping schedule can
        engage (models/attention.py)."""
        if self.windows is None:
            return (None,)
        p = len(self.windows)
        if self.n_layers % p:
            raise ValueError(f"window pattern period {p} must divide "
                             f"n_layers={self.n_layers}")
        return tuple(None if w == GLOBAL_WINDOW else int(w)
                     for w in self.windows)

    @property
    def is_pure_full_attention(self) -> bool:
        """True when every token-mixing layer is unwindowed softmax attention
        (these archs skip the ``long_500k`` cell; DESIGN.md §4)."""
        if self.block in ("rwkv",):
            return False
        if self.block == "hymba":
            return False
        lw = self.layer_windows()
        return bool((lw >= _BIG_WINDOW).all())

    # ------------------------------------------------------------------
    def param_count(self) -> int:
        """Analytic parameter count N (for MODEL_FLOPS = 6*N*D)."""
        d, hd = self.d_model, self.hd
        n_attn = d * (self.n_heads * hd) * 2 + d * (self.n_kv_heads * hd) * 2
        mlp_mats = 3 if self.gated else 2
        n_mlp = mlp_mats * d * self.d_ff
        n_layer = 0
        if self.block == "rwkv":
            n_layer = 5 * d * d + d * (5 * 32) + 5 * 32 * d + d * 64 + 64 * d \
                + 2 * d * self.d_ff + d * d
        elif self.block == "moe":
            n_exp = mlp_mats * d * self.d_ff_expert * self.n_experts
            n_layer = n_attn + n_exp + d * self.n_experts
            if self.dense_residual:
                n_layer += n_mlp
        elif self.block == "hymba":
            di = 2 * d
            n_ssm = d * 2 * di + di * (max(1, d // 16) + 2 * self.ssm_state) \
                + max(1, d // 16) * di + di * d
            n_layer = n_attn + n_ssm + n_mlp
        else:
            n_layer = n_attn + n_mlp
        total = self.n_layers * n_layer
        if self.enc_layers:
            total += self.enc_layers * (n_attn + n_mlp)      # encoder stack
            total += self.n_layers * n_attn                   # cross-attn
        total += self.vocab * d * (1 if self.tie_embeddings else 2)
        return int(total)

    def active_param_count(self) -> int:
        """Active params per token (MoE: only top-k experts count)."""
        if self.block != "moe":
            return self.param_count()
        mlp_mats = 3 if self.gated else 2
        per_exp = mlp_mats * self.d_model * self.d_ff_expert
        inactive = self.n_layers * per_exp * (self.n_experts - self.top_k)
        return int(self.param_count() - inactive)

    # ------------------------------------------------------------------
    def reduced(self) -> "ArchConfig":
        """Small same-family config for CPU smoke tests."""
        def shrink_heads(h):
            return max(1, min(h, 4))

        kv = shrink_heads(self.n_kv_heads)
        heads = max(kv * max(1, min(self.n_heads // max(self.n_kv_heads, 1), 2)), kv)
        return dataclasses.replace(
            self,
            n_layers=2,
            enc_layers=2 if self.enc_layers else 0,
            d_model=64,
            n_heads=heads,
            n_kv_heads=kv,
            head_dim=16,
            d_ff=128,
            d_ff_expert=32 if self.d_ff_expert else 0,
            n_experts=8 if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            capacity_factor=8.0,
            vocab=512,
            audio_ctx=24 if self.audio_ctx else 0,
            img_tokens=8 if self.img_tokens else 0,
            # keep a period-2 pattern (one windowed + one global layer) so
            # both attention schedules stay covered by the smoke tests
            windows=tuple(min(w, 16) if w else 0 for w in self.windows[:2])
            if self.windows else None,
            param_dtype="float32",
            compute_dtype="float32",
            remat=False,
        )


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode


SHAPES = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}
