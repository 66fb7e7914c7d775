"""Configuration dataclasses for the repro framework.

Every assigned architecture gets a module in this package exporting
``CONFIG: ModelConfig``.  ``repro_torch.configs.get_config`` maps ``--arch``
ids to them.  ``reduced()`` produces the CPU-smoke variant mandated by the spec
(<=2 layers, d_model<=512, <=4 experts).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace
from typing import Optional, Sequence, Tuple


# Per-layer block kinds understood by repro_torch.models.transformer.
ATTN = "attn"            # global self-attention (GQA)
ATTN_LOCAL = "attn_local"  # sliding-window self-attention
MAMBA2 = "mamba2"        # Mamba2 / SSD block
RWKV6 = "rwkv6"          # RWKV-6 (Finch) time-mix block
SHARED_ATTN = "shared_attn"  # zamba2-style shared (weight-tied) attention block


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    # Arctic keeps a dense residual MLP in parallel with the MoE FFN.
    dense_residual: bool = False
    router_aux_weight: float = 0.01
    # pad the expert dim to this count (0 = off) so it divides the TP mesh
    # axis; padded experts are router-masked (§Perf: expert-parallel for
    # counts like granite's 40 on a 16-wide axis)
    pad_to: int = 0
    # GShard dispatch group size (tokens per routing group); dispatch tensor
    # traffic scales with group x capacity ∝ group^2/E (§Perf iteration 3)
    dispatch_group: int = 512

    @property
    def padded_experts(self) -> int:
        return max(self.num_experts, self.pad_to)


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 64
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64       # mamba2 SSD head dim
    chunk: int = 256          # SSD chunk length


@dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str            # dense | moe | ssm | hybrid | vlm | audio | cnn
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0         # 0 -> d_model // n_heads
    source: str = ""         # citation
    # Attention pattern
    rope_theta: float = 500_000.0
    attn_window: int = 0      # sliding window size for ATTN_LOCAL layers
    local_global_ratio: int = 0   # gemma3: N local layers per 1 global
    # Per-arch block layout; if empty, all layers are ATTN.
    layer_pattern: Tuple[str, ...] = ()
    # zamba2: one shared attention+MLP block applied every `shared_every` layers
    shared_every: int = 0
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # Encoder-decoder (seamless): number of encoder layers (decoder = n_layers)
    encoder_layers: int = 0
    encoder_seq: int = 4096   # fixed source length for enc-dec input specs
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    dropout: float = 0.0
    # dtypes
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    # long_500k handling: "native" (sub-quadratic as designed) or
    # "window" (documented sliding-window variant, see DESIGN.md §6)
    long_context_mode: str = "window"
    attn_window_override: int = 8192   # used when long_context_mode == "window"
    # remat policy for train steps: "none" | "block" (checkpoint each block)
    remat: str = "block"

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // max(self.n_heads, 1))

    # ----- derived -----
    @property
    def blocks(self) -> Tuple[str, ...]:
        """Resolved per-layer block kinds, length n_layers."""
        if self.layer_pattern:
            pat = self.layer_pattern
            reps = (self.n_layers + len(pat) - 1) // len(pat)
            return tuple((pat * reps)[: self.n_layers])
        if self.arch_type == "ssm" and self.ssm is not None:
            return tuple([MAMBA2] * self.n_layers)
        if self.local_global_ratio > 0:
            out = []
            for i in range(self.n_layers):
                # gemma3: pattern of N local then 1 global
                out.append(ATTN if (i % (self.local_global_ratio + 1)
                                    == self.local_global_ratio) else ATTN_LOCAL)
            return tuple(out)
        return tuple([ATTN] * self.n_layers)

    def param_count(self) -> int:
        """Analytic parameter count (used for 6ND roofline math)."""
        D, F, V, L = self.d_model, self.d_ff, self.vocab_size, self.n_layers
        H, KV, hd = self.n_heads, self.n_kv_heads, self.head_dim
        emb = V * D * (1 if self.tie_embeddings else 2)
        total = emb
        if self.encoder_layers:
            total += self._enc_dec_params()
            return total
        attn = D * H * hd + 2 * D * KV * hd + H * hd * D
        mlp_dense = 3 * D * F  # swiglu
        for kind in self.blocks:
            total += 2 * D  # norms
            if kind in (ATTN, ATTN_LOCAL):
                total += attn + mlp_dense
            elif kind == MAMBA2:
                s = self.ssm or SSMConfig()
                d_in = s.expand * D
                nh = d_in // s.head_dim
                total += D * (2 * d_in + 2 * nh * s.d_state + nh) + d_in * D \
                    + s.d_conv * (d_in + 2 * nh * s.d_state) + d_in
            elif kind == RWKV6:
                total += 4 * D * D + D * D // 2 + 2 * D * F  # time-mix + channel-mix(relu^2)
            if self.moe is not None and kind in (ATTN, ATTN_LOCAL, SHARED_ATTN):
                pass
        if self.moe is not None:
            # replace dense MLP with MoE on MoE layers (all layers here)
            total -= mlp_dense * self.n_layers
            e = self.moe
            per_layer = e.num_experts * 3 * D * e.d_ff_expert + D * e.num_experts
            if e.dense_residual:
                per_layer += 3 * D * F
            total += per_layer * self.n_layers
        if self.shared_every:
            # one shared attention+MLP block (weight-tied)
            total += attn + mlp_dense + 2 * D
        return total

    def _enc_dec_params(self) -> int:
        D, F = self.d_model, self.d_ff
        H, KV, hd = self.n_heads, self.n_kv_heads, self.head_dim
        attn = D * H * hd + 2 * D * KV * hd + H * hd * D
        mlp = 3 * D * F
        enc = self.encoder_layers * (attn + mlp + 2 * D)
        dec = self.n_layers * (2 * attn + mlp + 3 * D)  # self + cross attn
        return enc + dec

    def active_param_count(self) -> int:
        """Active params per token (MoE top-k instead of all experts)."""
        if self.moe is None:
            return self.param_count()
        total = self.param_count()
        e = self.moe
        inactive = (e.num_experts - e.top_k) * 3 * self.d_model * e.d_ff_expert
        return total - inactive * self.n_layers


def reduced(cfg: ModelConfig, *, layers: int = 2, d_model: int = 256,
            n_heads: int = 4, vocab: int = 512) -> ModelConfig:
    """CPU-smoke variant of the same architecture family (spec mandate)."""
    kv = min(cfg.n_kv_heads, n_heads)
    if cfg.n_kv_heads < cfg.n_heads:
        kv = max(1, n_heads // max(1, cfg.n_heads // max(cfg.n_kv_heads, 1)))
    moe = None
    if cfg.moe is not None:
        moe = replace(cfg.moe, num_experts=4, top_k=min(cfg.moe.top_k, 2),
                      d_ff_expert=2 * d_model)
    ssm = None
    if cfg.ssm is not None:
        ssm = replace(cfg.ssm, d_state=16, head_dim=32, chunk=32)
    pat = cfg.layer_pattern
    if pat:
        pat = tuple(pat[:layers]) if len(pat) >= layers else pat
    return replace(
        cfg,
        name=cfg.name + "-reduced",
        n_layers=layers,
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=kv,
        head_dim=d_model // n_heads,
        d_ff=2 * d_model,
        vocab_size=vocab,
        layer_pattern=pat,
        moe=moe,
        ssm=ssm,
        encoder_layers=min(cfg.encoder_layers, layers),
        encoder_seq=64,
        attn_window=min(cfg.attn_window, 16) if cfg.attn_window else 0,
        shared_every=2 if cfg.shared_every else 0,
        param_dtype="float32",
        compute_dtype="float32",
        remat="none",
    )


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


@dataclass(frozen=True)
class TrainConfig:
    """Hyper-parameters for the training loop / hybrid schedule."""
    optimizer: str = "sgd"        # sgd | adamw
    learning_rate: float = 0.2
    momentum: float = 0.9
    weight_decay: float = 1e-4
    warmup_epochs: int = 5
    # dual-batch learning
    extra_time_ratio: float = 1.05     # paper's k
    n_workers: int = 4
    n_small: int = 3                   # paper's best CIFAR config
    update_factor: str = "ds_over_dl"  # ds_over_dl | sqrt | none
    # cyclic progressive learning
    stages: Tuple[int, ...] = (80, 40, 20)        # epochs per LR stage
    stage_lrs: Tuple[float, ...] = (0.2, 0.02, 0.002)
    sub_resolutions: Tuple[int, ...] = (24, 32)   # or seq lens for LLMs
    sub_dropouts: Tuple[float, ...] = (0.1, 0.2)
