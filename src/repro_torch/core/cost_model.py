"""Per-layer cost model.

P3 only needs, for every layer j:
  c_j  — compute load (multiplications)                eq. (1)/(2)
  m_j  — weight memory in bytes                        eq. (3)
  K_j  — output/activation size in bits (transfer)     eq. (14)

This module produces those vectors for (a) the paper's own CNNs via the
exact eq. (1)-(3) formulas, and (b) every LM architecture at a
``ShapeConfig`` (``arch_cost``), so the same planner drives both the UAV
swarm and the pipeline-stage placement (``core.pipeline_opt``).  The
arithmetic is the reference's, in float64, operation for operation.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

from repro_torch.configs.base import ArchConfig, CNNConfig, ShapeConfig


@dataclass(frozen=True)
class LayerCost:
    """Cost vector of one placeable unit (one CNN layer / one block)."""

    name: str
    flops: float            # c_j  (multiply ops; MACs)
    weight_bytes: float     # m_j
    act_bits: float         # K_j: bits transferred to the NEXT layer
    kind: str = "layer"
    # decode-time state carried between steps (KV cache / recurrent state)
    state_bytes: float = 0.0


@dataclass(frozen=True)
class ModelCost:
    name: str
    layers: Tuple[LayerCost, ...]
    input_bits: float        # K_s: source data size (eq. 12)

    @property
    def total_flops(self) -> float:
        return sum(l.flops for l in self.layers)

    @property
    def total_weight_bytes(self) -> float:
        return sum(l.weight_bytes for l in self.layers)


def _conv_out(in_spatial: int, k: int, stride: int, pad: int) -> int:
    return (in_spatial + 2 * pad - k) // stride + 1


def cnn_cost(cfg: CNNConfig, act_bits_per_elem: int = 32) -> ModelCost:
    """Per-layer (c_j, m_j, K_j) for a CNN per eq. (1)-(3)."""
    layers: List[LayerCost] = []
    spatial = cfg.input_hw
    channels = cfg.input_channels
    flat: Optional[int] = None
    for spec in cfg.layers:
        if spec.kind == "conv":
            z = spec.out_spatial or _conv_out(spatial, spec.kernel,
                                              spec.stride, spec.padding)
            n_prev, n_j, s_j = spec.in_channels or channels, spec.out_channels, spec.kernel
            flops = float(n_prev) * s_j ** 2 * n_j * z ** 2        # eq. (1)
            weights = float(n_prev) * s_j ** 2 * n_j + n_j          # + bias
            act = float(n_j) * z ** 2 * act_bits_per_elem
            layers.append(LayerCost(spec.name, flops,
                                    weights * cfg.weight_bits / 8.0, act, "conv"))
            spatial, channels = z, n_j
        elif spec.kind == "pool":
            z = spec.out_spatial or _conv_out(spatial, spec.kernel,
                                              spec.stride, spec.padding)
            # pooling: comparisons only; the paper folds these into the conv
            # layer's UAV, so cost ~ 0 compute, 0 weights.
            act = float(channels) * z ** 2 * act_bits_per_elem
            layers.append(LayerCost(spec.name, 0.0, 0.0, act, "pool"))
            spatial = z
        elif spec.kind == "fc":
            n_prev = spec.in_features or (flat if flat is not None
                                          else channels * spatial ** 2)
            n_j = spec.out_features
            flops = float(n_prev) * n_j                             # eq. (2)
            weights = float(n_prev) * n_j + n_j
            act = float(n_j) * act_bits_per_elem
            layers.append(LayerCost(spec.name, flops,
                                    weights * cfg.weight_bits / 8.0, act, "fc"))
            flat = n_j
        else:
            raise ValueError(f"unknown layer kind {spec.kind}")
    input_bits = float(cfg.input_hw ** 2 * cfg.input_channels * 8)  # 8-bit px
    return ModelCost(cfg.name, tuple(layers), input_bits)


# ---------------------------------------------------------------------------
# LM cost model (generalizes eq. (1)-(3) to the LM architectures).  All
# FLOPs counted as MACs to stay unit-compatible with the paper's c_j.
# ---------------------------------------------------------------------------

_BYTES = {"float32": 4, "bfloat16": 2, "int8": 1}


def _attn_block_cost(cfg: ArchConfig, seq: int, batch: int, kind: str,
                     window: int, bytes_w: int, bytes_a: int,
                     name: str) -> LayerCost:
    """One attention+MLP transformer block."""
    d, hd = cfg.d_model, cfg.head_dim
    nh, nkv = cfg.attention.n_heads, cfg.attention.n_kv_heads
    q_dim, kv_dim = nh * hd, nkv * hd
    # projections (per token): q,k,v,o
    proj = d * q_dim + 2 * d * kv_dim + q_dim * d
    # attention context length per query token
    ctx = min(seq, window) if window else seq
    if kind == "decode":
        tok = batch                       # one new token per sequence
        attn = nh * hd * ctx * 2          # qk + av per head, against cache
        mac_tok = proj + attn
    else:
        tok = batch * seq
        attn = nh * hd * (ctx / 2.0 if not window else ctx) * 2  # causal ~ /2
        mac_tok = proj + attn
    # MLP
    if cfg.moe.enabled:
        d_e = cfg.moe.d_expert
        mlp_tok = cfg.moe.top_k * (3 if cfg.glu else 2) * d * d_e
        mlp_w = cfg.moe.n_experts * (3 if cfg.glu else 2) * d * d_e
        router_w = d * cfg.moe.n_experts
        mlp_tok += d * cfg.moe.n_experts      # router matmul
        mlp_w += router_w
    else:
        mlp_tok = (3 if cfg.glu else 2) * d * cfg.d_ff
        mlp_w = mlp_tok
    flops = float(tok) * (mac_tok + mlp_tok)
    weights = float(proj + mlp_w + 2 * d) * bytes_w   # + 2 norms
    if cfg.attention.qkv_bias:
        weights += (q_dim + 2 * kv_dim) * bytes_w
    act_bits = float(tok) * d * bytes_a * 8
    state = float(batch) * ctx * 2 * kv_dim * bytes_a   # KV cache
    return LayerCost(name, flops, weights, act_bits, "attn", state)


def _recurrent_block_cost(cfg: ArchConfig, seq: int, batch: int, kind: str,
                          bytes_w: int, bytes_a: int, name: str,
                          flavor: str) -> LayerCost:
    """RG-LRU (griffin) or xLSTM block: O(1) decode state."""
    d = cfg.d_model
    w = cfg.rglru_width or d
    tok = batch if kind == "decode" else batch * seq
    if flavor == "rglru":
        # in/out proj + gates + conv1d
        mac_tok = 2 * d * w + 2 * w * w + cfg.rglru_conv_size * w + 4 * w
        weights = 2 * d * w + 2 * w * w + cfg.rglru_conv_size * w + 4 * w
        state = float(batch) * w * bytes_a
    else:  # xlstm (sLSTM or mLSTM)
        hd = cfg.head_dim
        nh = cfg.attention.n_heads
        mac_tok = 4 * d * d + nh * hd * hd    # qkv+o proj + matrix-memory
        weights = 4 * d * d + nh * hd * hd
        state = float(batch) * nh * hd * hd * bytes_a  # mLSTM matrix state
    mlp_tok = (3 if cfg.glu else 2) * d * cfg.d_ff if cfg.d_ff else 2 * d * d
    mlp_w = mlp_tok
    flops = float(tok) * (mac_tok + mlp_tok)
    act_bits = float(tok) * d * bytes_a * 8
    return LayerCost(name, flops, float(weights + mlp_w + 2 * d) * bytes_w,
                     act_bits, flavor, state)


def _block_kinds(cfg: ArchConfig) -> List[str]:
    """Per-layer block kind sequence of an LM stack (the reference's
    ``core/cost_model.py::_block_kinds``): the same strings name the
    planner's units and the model's blocks."""
    kinds: List[str] = []
    pat = cfg.attention.pattern
    for i in range(cfg.n_layers):
        if cfg.family == "ssm":
            kinds.append("mlstm" if (i % cfg.xlstm_mlstm_every)
                         == cfg.xlstm_mlstm_every - 1 else "slstm")
        elif pat == "griffin":
            kinds.append("attn_local" if i % 3 == 2 else "rglru")
        elif pat == "alternating":
            kinds.append("attn_local" if i % 2 == 0 else "attn_full")
        elif pat == "local":
            kinds.append("attn_local")
        else:
            kinds.append("attn_full")
    return kinds


def arch_cost(cfg: ArchConfig, shape: ShapeConfig) -> ModelCost:
    """Per-block (c_j, m_j, K_j) for an LM architecture at a shape."""
    bytes_w = _BYTES[cfg.param_dtype]
    bytes_a = _BYTES[cfg.dtype]
    seq, batch, kind = shape.seq_len, shape.global_batch, shape.kind
    layers: List[LayerCost] = []
    # embedding "layer" (lookup: no MACs, big weights)
    emb_w = float(cfg.vocab_size) * cfg.d_model * bytes_w
    tok = batch if kind == "decode" else batch * seq
    layers.append(LayerCost("embed", 0.0, emb_w,
                            float(tok) * cfg.d_model * bytes_a * 8, "embed"))
    for i, k in enumerate(_block_kinds(cfg)):
        nm = f"block_{i}:{k}"
        if k in ("attn_full", "attn_local"):
            win = cfg.attention.window if k == "attn_local" else 0
            layers.append(_attn_block_cost(cfg, seq, batch, kind, win,
                                           bytes_w, bytes_a, nm))
        elif k == "rglru":
            layers.append(_recurrent_block_cost(cfg, seq, batch, kind,
                                                bytes_w, bytes_a, nm, "rglru"))
        else:  # slstm / mlstm
            layers.append(_recurrent_block_cost(cfg, seq, batch, kind,
                                                bytes_w, bytes_a, nm, "xlstm"))
    # whisper: prepend encoder blocks (bidirectional over enc_seq)
    if cfg.enc_layers:
        enc = [_attn_block_cost(cfg, cfg.enc_seq, batch, "prefill", 0,
                                bytes_w, bytes_a, f"enc_{i}")
               for i in range(cfg.enc_layers)]
        layers = [layers[0]] + enc + layers[1:]
    # LM head
    head_flops = float(tok) * cfg.d_model * cfg.vocab_size
    head_w = 0.0 if cfg.tie_embeddings else emb_w
    layers.append(LayerCost("lm_head", head_flops, head_w,
                            float(tok) * cfg.vocab_size * bytes_a * 8, "head"))
    if kind == "train":  # backward ~ 2x forward
        layers = [LayerCost(l.name, l.flops * 3.0, l.weight_bytes,
                            l.act_bits, l.kind, l.state_bytes) for l in layers]
    input_bits = float(tok) * 4 * 8   # int32 token ids
    return ModelCost(cfg.name, tuple(layers), input_bits)


def arch_param_count(cfg: ArchConfig) -> int:
    """Analytic parameter count from the cost model (weights / dtype bytes)."""
    mc = arch_cost(cfg, ShapeConfig("probe", 128, 1, "prefill"))
    bytes_w = _BYTES[cfg.param_dtype]
    return int(sum(l.weight_bytes for l in mc.layers) / bytes_w)


def model_flops(cfg: ArchConfig, shape: ShapeConfig) -> float:
    """MODEL_FLOPS for the roofline: 6·N·D train / 2·N_active·D inference."""
    n = arch_param_count(cfg)
    if cfg.moe.enabled:
        dense = n - cfg.n_layers * cfg.moe.n_experts * \
            (3 if cfg.glu else 2) * cfg.d_model * cfg.moe.d_expert
        active = dense + cfg.n_layers * cfg.moe.top_k * \
            (3 if cfg.glu else 2) * cfg.d_model * cfg.moe.d_expert
        n = int(active)
    d = shape.global_batch * (1 if shape.kind == "decode" else shape.seq_len)
    return (6.0 if shape.kind == "train" else 2.0) * n * d


__all__ = ["LayerCost", "ModelCost", "cnn_cost", "_BYTES",
           "_attn_block_cost", "_recurrent_block_cost", "_block_kinds",
           "arch_cost", "arch_param_count", "model_flops"]
