"""Config system: architecture + shape + parallelism + run configs.

Copy of ``repro/configs/base.py`` for the PyTorch port, verbatim:
its relative imports resolve inside ``repro_torch``, which
keeps the reference's module layout.

Every assigned architecture gets a ``src/repro/configs/<id>.py`` exposing
``CONFIG`` (full published size) and ``SMOKE`` (same family, tiny).  Shapes
(``train_4k``/``prefill_32k``/``decode_32k``/``long_500k``) are defined in
``shapes.py`` and paired with every arch per the assignment.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field


@dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 768
    kv_lora_rank: int = 256
    qk_nope_head_dim: int = 64
    qk_rope_head_dim: int = 32
    v_head_dim: int = 64


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 16
    top_k: int = 2
    every: int = 1               # MoE FFN on layers where (idx % every == every-1)
    num_shared: int = 0          # always-on shared experts (llama4)
    d_ff: int = 0                # expert hidden dim (0 -> cfg.d_ff)
    capacity_factor: float = 1.25


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0             # 0 -> ceil(d_model/16)


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                          # dense | moe | hybrid | ssm | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                    # 0 -> d_model // num_heads

    # layer pattern: tuple of per-position-in-period mixer kinds.
    # e.g. dense: ("attn",); gemma3: ("local",)*5 + ("attn",);
    # jamba: ("mamba","mamba","mamba","attn","mamba","mamba","mamba","mamba")
    period_pattern: tuple = ("attn",)
    window_size: int = 1024              # sliding window for "local" mixers

    mla: MLAConfig | None = None
    moe: MoEConfig | None = None
    ssm: SSMConfig | None = None

    # enc-dec (seamless): encoder depth; num_layers is the decoder depth
    enc_layers: int = 0
    # vlm: number of prefix patch embeddings provided by the (stubbed) frontend
    num_patches: int = 0
    # audio: encoder consumes precomputed frame embeddings instead of tokens
    frame_input: bool = False

    act: str = "silu"
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    dtype: str = "bfloat16"              # activation/compute dtype
    param_dtype: str = "float32"

    # training
    remat: str = "full"                  # full | none
    loss_chunk: int = 512                # vocab-loss sequence chunking

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def n_periods(self) -> int:
        return self.num_layers // len(self.period_pattern)

    @property
    def remainder_kinds(self) -> tuple:
        r = self.num_layers % len(self.period_pattern)
        return self.period_pattern[:r]

    def ffn_kind(self, layer_idx: int) -> str:
        if self.moe is None:
            return "mlp"
        return "moe" if (layer_idx % self.moe.every) == (self.moe.every - 1) \
            else "mlp"

    def param_count(self) -> tuple[int, int]:
        """(total, active) parameter estimate (embeddings included once)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.resolved_head_dim
        h, kvh = self.num_heads, self.num_kv_heads
        total = active = v * d + (0 if self.tie_embeddings else v * d)
        per_layer_attn = d * h * hd + 2 * d * kvh * hd + h * hd * d + 2 * d
        if self.mla is not None:
            m = self.mla
            qd = m.qk_nope_head_dim + m.qk_rope_head_dim
            per_layer_attn = (d * m.q_lora_rank + m.q_lora_rank * h * qd
                              + d * (m.kv_lora_rank + m.qk_rope_head_dim)
                              + m.kv_lora_rank * h * (m.qk_nope_head_dim
                                                      + m.v_head_dim)
                              + h * m.v_head_dim * d + 2 * d)
        mlp_p = 3 * d * f
        for i in range(self.num_layers):
            kind = self.period_pattern[i % len(self.period_pattern)]
            if kind == "mamba":
                s = self.ssm or SSMConfig()
                di = s.expand * d
                dtr = s.dt_rank or -(-d // 16)
                mix = (d * 2 * di + di * s.d_conv + di * (dtr + 2 * s.d_state)
                       + dtr * di + di + di * d)
            elif kind in ("mlstm", "slstm"):
                di = 2 * d
                mix = d * di * 4 + di * d + 4 * d * 4   # q,k,v,z + out + gates
            else:
                mix = per_layer_attn
            if self.ffn_kind(i) == "moe":
                mcfg = self.moe
                ef = mcfg.d_ff or f
                ffn = mcfg.num_experts * 3 * d * ef + d * mcfg.num_experts
                ffn_act = (mcfg.top_k + mcfg.num_shared) * 3 * d * ef \
                    + d * mcfg.num_experts
                if mcfg.num_shared:
                    ffn += mcfg.num_shared * 3 * d * ef
            elif kind in ("mlstm", "slstm") and f == 0:
                ffn = ffn_act = 0
            else:
                ffn = ffn_act = mlp_p
            total += mix + ffn
            active += mix + (ffn_act if self.ffn_kind(i) == "moe" else ffn)
        if self.enc_layers:
            # encoder self-attn + mlp, plus decoder cross-attn already counted?
            enc = self.enc_layers * (per_layer_attn + mlp_p)
            cross = self.num_layers * per_layer_attn
            total += enc + cross
            active += enc + cross
        return total, active


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str              # train | prefill | decode
    seq_len: int
    global_batch: int


@dataclass(frozen=True)
class RunConfig:
    arch: ModelConfig
    shape: ShapeConfig
    # parallelism
    use_pallas: bool = False           # True on real TPU
    zero1: bool = False                # shard optimizer state over data axis
    seq_shard_long: bool = True        # context-parallel KV for batch < data
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
