"""The paper's own CNNs (LeNet, AlexNet) in PyTorch, built from the same
``CNNConfig`` layer specs the cost model reads, so the planner's
placement units are executable layers one for one.

Layouts are the reference's: activations NHWC, conv filters HWIO, FC
weights [in, out], and the FC input flattened in (H, W, C) order.  Conv
layers run the port's conv2d op (im2col + the GEMM kernel on the card);
pooling and the FC layers are plain PyTorch, as the reference leaves them
to XLA.

``apply_layers`` executes a contiguous slice of layers: each UAV runs its
slice and hands the activation on.  Each layer runs inside a profiler
range named ``cnn.<kind>`` (``cnn.conv``, ``cnn.pool``, ``cnn.fc``).  Every operation is deterministic for
a given shape, so sliced execution equals monolithic execution bit for
bit.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import CNNConfig, ConvLayerSpec
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.conv2d.ops import conv2d

Params = Dict[str, torch.Tensor]


def _conv_out(s: int, k: int, stride: int, pad: int) -> int:
    return (s + 2 * pad - k) // stride + 1


def _trunc_normal(shape, fan_in: int, generator: torch.Generator
                  ) -> torch.Tensor:
    w = torch.empty(shape, dtype=torch.float32)
    torch.nn.init.trunc_normal_(w, a=-2.0, b=2.0, generator=generator)
    return w / math.sqrt(fan_in)


def layer_shapes(cfg: CNNConfig, batch: int
                 ) -> List[Tuple[Tuple[int, ...], Tuple[int, ...]]]:
    """Each layer's (input, output) activation shape at ``batch`` images:
    NHWC around conv and pool layers, [batch, features] around FC layers
    (the first FC layer's input is the flattened NHWC activation)."""
    shapes = []
    shape: Tuple[int, ...] = (batch, cfg.input_hw, cfg.input_hw,
                              cfg.input_channels)
    for spec in cfg.layers:
        if spec.kind == "fc":
            shape = (batch, spec.in_features or math.prod(shape[1:]))
            nxt: Tuple[int, ...] = (batch, spec.out_features)
        else:
            s = _conv_out(shape[1], spec.kernel, spec.stride, spec.padding)
            nxt = (batch, s, s, spec.out_channels if spec.kind == "conv"
                   else shape[3])
        shapes.append((shape, nxt))
        shape = nxt
    return shapes


def init_cnn(cfg: CNNConfig, generator: torch.Generator,
             device: DeviceLike = None) -> List[Params]:
    """One params dict per layer spec (pools get empty dicts): weights
    truncated normal in [-2, 2] / sqrt(fan_in), zero biases.  The draws
    come from ``generator`` (a CPU generator) on the host, so a seed gives
    the same parameters on every device."""
    dev = resolve_device(device)
    params: List[Params] = []
    for spec, (x_shape, _) in zip(cfg.layers, layer_shapes(cfg, 1)):
        if spec.kind == "conv":
            n_in = spec.in_channels or x_shape[-1]
            w = _trunc_normal((spec.kernel, spec.kernel, n_in,
                               spec.out_channels),
                              n_in * spec.kernel ** 2, generator)
            params.append({"w": w.to(dev),
                           "b": torch.zeros(spec.out_channels, device=dev)})
        elif spec.kind == "pool":
            params.append({})
        else:
            w = _trunc_normal((x_shape[1], spec.out_features), x_shape[1],
                              generator)
            params.append({"w": w.to(dev),
                           "b": torch.zeros(spec.out_features, device=dev)})
    return params


def apply_layer(spec: ConvLayerSpec, p: Params, x: torch.Tensor,
                last_fc: bool) -> torch.Tensor:
    """x: NHWC for conv/pool, [B, F] for fc (flattened in NHWC order)."""
    if spec.kind == "conv":
        return conv2d(x, p["w"], p["b"], stride=spec.stride,
                      padding=spec.padding, relu=True)
    if spec.kind == "pool":          # VALID max window (init -inf)
        win = x.unfold(1, spec.kernel, spec.stride).unfold(
            2, spec.kernel, spec.stride)              # [N,OH,OW,C,KH,KW]
        return win.amax((-2, -1))
    if x.dim() > 2:
        x = x.reshape(x.shape[0], -1)
    y = x @ p["w"] + p["b"]
    return y if last_fc else torch.clamp_min(y, 0.0)


def apply_layers(cfg: CNNConfig, params: Sequence[Params], x: torch.Tensor,
                 start: int = 0, stop: Optional[int] = None) -> torch.Tensor:
    """Execute layers [start, stop) — a placement slice."""
    stop = len(cfg.layers) if stop is None else stop
    last_fc_idx = max(i for i, s in enumerate(cfg.layers) if s.kind == "fc")
    for i in range(start, stop):
        with torch.profiler.record_function(f"cnn.{cfg.layers[i].kind}"):
            x = apply_layer(cfg.layers[i], params[i], x,
                            last_fc=i == last_fc_idx)
    return x


def forward(cfg: CNNConfig, params: Sequence[Params],
            x: torch.Tensor) -> torch.Tensor:
    return apply_layers(cfg, params, x)


def distributed_forward(cfg: CNNConfig, params: Sequence[Params],
                        x: torch.Tensor,
                        assign: Sequence[int]) -> Tuple[torch.Tensor, int]:
    """Execute the model as the LLHR placement would: one contiguous run
    per device change, counting hand-offs.  Equal to ``forward`` bit for
    bit."""
    transfers = 0
    i = 0
    while i < len(cfg.layers):
        j = i
        while j < len(cfg.layers) and assign[j] == assign[i]:
            j += 1
        x = apply_layers(cfg, params, x, i, j)
        if j < len(cfg.layers):
            transfers += 1
        i = j
    return x, transfers


__all__ = ["Params", "layer_shapes", "init_cnn", "apply_layer", "apply_layers", "forward",
           "distributed_forward"]
