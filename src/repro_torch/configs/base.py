"""Config dataclasses: the paper's CNNs (eq. (1)-(3) layer
parameterization), the LM architectures and the input shapes the
pipeline planner plans them at, the serving loop, and training (the
optimiser and checkpoint settings, the mesh and the run)."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Tuple


@dataclass(frozen=True)
class ConvLayerSpec:
    """One CNN layer in the paper's eq (1)-(3) parameterization."""

    name: str
    kind: str                   # 'conv' | 'pool' | 'fc'
    in_channels: int = 0        # n_{j-1}
    out_channels: int = 0       # n_j
    kernel: int = 0             # s_j
    stride: int = 1
    padding: int = 0
    out_spatial: int = 0        # z_j (computed if 0)
    in_features: int = 0        # fc: n_{j-1}
    out_features: int = 0       # fc: n_j


@dataclass(frozen=True)
class CNNConfig:
    name: str
    input_hw: int
    input_channels: int
    layers: Tuple[ConvLayerSpec, ...]
    weight_bits: int = 32       # b in eq (3)

    @property
    def family(self) -> str:
        return "cnn"


# ---------------------------------------------------------------------------
# LM shapes and architecture config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeConfig:
    """One input shape an architecture is planned at."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


# The four LM shapes.
TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")
ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES_BY_NAME = {s.name: s for s in ALL_SHAPES}


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts block parameters."""

    n_experts: int = 0
    top_k: int = 0
    d_expert: int = 0          # per-expert hidden size
    router_jitter: float = 0.0
    aux_loss_weight: float = 0.01
    # expert capacity = ceil(S * top_k / n_experts * capacity_factor);
    # E/top_k makes dispatch drop-free (used by reduced smoke configs).
    capacity_factor: float = 1.25

    @property
    def enabled(self) -> bool:
        return self.n_experts > 0


@dataclass(frozen=True)
class AttentionConfig:
    """Attention block parameters (full / local / alternating)."""

    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0
    qkv_bias: bool = False
    logit_softcap: float = 0.0        # gemma2: 50.0 on attention logits
    window: int = 0                    # sliding window size; 0 = full
    # pattern over layers: 'full', 'local', 'alternating' (gemma2 L/G),
    # 'griffin' (2 recurrent : 1 local-attn)
    pattern: str = "full"
    rope_theta: float = 10000.0
    mrope_sections: Tuple[int, ...] = ()   # qwen2-vl M-RoPE section split


@dataclass(frozen=True)
class ArchConfig:
    """Architecture of one LM: the reference's fields that the served
    families read, whisper's encoder (``enc_layers``, ``enc_seq``) and
    the VLM's prepended patch embeddings (``vision_tokens``) included,
    and those the pipeline planner reads: the weights' dtype
    (``param_dtype``, also the training master weights' dtype), the
    shapes the architecture is planned at (``supported_shapes``) and its
    analytic parameter count (``n_params``); ``remat`` is training's
    recomputation of each layer's activations in the backward pass
    (``none`` | ``full`` | ``dots``: the port checkpoints whole layers for
    both of the latter)."""

    name: str
    family: str                 # dense | ssm | hybrid | audio | vlm | moe
    n_layers: int
    d_model: int
    d_ff: int
    vocab_size: int
    attention: AttentionConfig = field(default_factory=AttentionConfig)
    moe: MoEConfig = field(default_factory=MoEConfig)

    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    final_logit_softcap: float = 0.0   # gemma2: 30.0
    act: str = "silu"                  # mlp activation ('silu'|'gelu'|'relu')
    glu: bool = True                   # gated MLP (SwiGLU/GeGLU)
    xlstm_mlstm_every: int = 2         # xlstm: one mLSTM block every n
    # griffin / recurrentgemma: RG-LRU width & conv1d size
    rglru_width: int = 0
    rglru_conv_size: int = 4
    # whisper: encoder stack (the decoder has n_layers)
    enc_layers: int = 0
    enc_seq: int = 1500                # precomputed frame embeddings (stub)
    # vlm: number of prepended vision patch embeddings (stub frontend)
    vision_tokens: int = 0
    # training: recompute each layer's activations in the backward
    remat: str = "full"                # 'none' | 'full' | 'dots'
    dtype: str = "bfloat16"            # compute (and weight matrix) dtype
    param_dtype: str = "float32"       # the planner's weight bytes
    # which shape names this arch supports (long_500k gated by attention kind)
    supported_shapes: Tuple[str, ...] = (
        "train_4k", "prefill_32k", "decode_32k")

    @property
    def head_dim(self) -> int:
        a = self.attention
        if a.head_dim:
            return a.head_dim
        return self.d_model // max(a.n_heads, 1)

    @property
    def n_params(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        from repro_torch.core.cost_model import arch_param_count
        return arch_param_count(self)

    def supports(self, shape: ShapeConfig) -> bool:
        return shape.name in self.supported_shapes

    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU tests (the reference's rule:
        <= 4 heads of width 16, <= 4 layers, d_ff 128, vocab 256, window
        <= 32, float32, no remat; MoE at <= 8 experts, top-k <= 2, d_expert 32 and a
        drop-free capacity factor; RG-LRU width 64; M-RoPE sections
        (4, 2, 2); <= 2 encoder layers over 16 frames, 0 frames without
        an encoder; 8 vision tokens)."""
        a = self.attention
        heads = min(a.n_heads, 4) or 4
        kv = max(1, min(a.n_kv_heads, heads))
        if a.n_kv_heads and a.n_kv_heads < a.n_heads:
            kv = max(1, heads // 2)     # GQA stays GQA
        red_attn = dataclasses.replace(
            a, n_heads=heads, n_kv_heads=kv, head_dim=16,
            window=min(a.window, 32) if a.window else 0,
            mrope_sections=(4, 2, 2) if a.mrope_sections else ())
        red_moe = self.moe
        if self.moe.enabled:
            ne = min(8, self.moe.n_experts)
            tk = min(2, self.moe.top_k)
            red_moe = dataclasses.replace(
                self.moe, n_experts=ne, top_k=tk, d_expert=32,
                capacity_factor=float(ne) / tk)   # drop-free for exact tests
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=min(self.n_layers, 4),
            d_model=heads * 16,
            d_ff=128,
            vocab_size=256,
            attention=red_attn,
            moe=red_moe,
            rglru_width=64 if self.rglru_width else 0,
            enc_layers=min(self.enc_layers, 2),
            enc_seq=16 if self.enc_layers else 0,
            vision_tokens=8 if self.vision_tokens else 0,
            remat="none",
            dtype="float32",
        )


@dataclass(frozen=True)
class ServeConfig:
    max_batch: int = 8
    max_seq: int = 2048
    eos_id: int = 1
    temperature: float = 0.0


# ---------------------------------------------------------------------------
# Mesh / run configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MeshConfig:
    """A device mesh's shape and axis names (the reference's pod meshes;
    the port trains on one card and keeps them as the run's record)."""

    shape: Tuple[int, ...] = (16, 16)
    axes: Tuple[str, ...] = ("data", "model")

    @property
    def n_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    @property
    def multi_pod(self) -> bool:
        return "pod" in self.axes


SINGLE_POD_MESH = MeshConfig((16, 16), ("data", "model"))
MULTI_POD_MESH = MeshConfig((2, 16, 16), ("pod", "data", "model"))


@dataclass(frozen=True)
class TrainConfig:
    steps: int = 100
    lr: float = 3e-4
    warmup_steps: int = 10
    decay_frac: float = 0.1          # WSD: final decay fraction of steps
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    microbatches: int = 1            # gradient accumulation
    grad_compress: bool = False      # int8 error-feedback compression
    seed: int = 0
    checkpoint_every: int = 50
    checkpoint_dir: str = "/tmp/repro_ckpt"
    async_checkpoint: bool = True
    schedule: str = "wsd"            # 'wsd' | 'cosine' | 'constant'


@dataclass(frozen=True)
class RunConfig:
    arch: str = "minicpm-2b"
    shape: str = "train_4k"
    mesh: MeshConfig = field(default_factory=lambda: SINGLE_POD_MESH)
    train: TrainConfig = field(default_factory=TrainConfig)
    serve: ServeConfig = field(default_factory=ServeConfig)


__all__ = ["ALL_SHAPES", "ArchConfig", "AttentionConfig", "CNNConfig",
           "ConvLayerSpec", "DECODE_32K", "LONG_500K", "MULTI_POD_MESH",
           "MeshConfig", "MoEConfig", "PREFILL_32K", "RunConfig",
           "SHAPES_BY_NAME", "SINGLE_POD_MESH", "ServeConfig",
           "ShapeConfig", "TRAIN_4K", "TrainConfig"]
