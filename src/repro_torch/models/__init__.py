"""The port's models: the paper's CNNs (``models.cnn``) and the served
LMs (``models.transformer.TransformerLM``, and whisper's encoder-decoder
``models.whisper.WhisperLM``); ``build_model`` picks one from a
config."""
from __future__ import annotations

from typing import Union

from repro_torch.configs.base import ArchConfig, CNNConfig
from repro_torch.device import DeviceLike


def build_model(cfg: Union[ArchConfig, CNNConfig],
                device: DeviceLike = None):
    """Config -> the ``models.cnn`` module (a CNN's functions take their
    device with the parameters), a ``WhisperLM`` (family ``audio``) or a
    ``TransformerLM`` on ``device``."""
    if isinstance(cfg, CNNConfig):
        from repro_torch.models import cnn
        return cnn
    if cfg.family == "audio":
        from repro_torch.models.whisper import WhisperLM
        return WhisperLM(cfg, device)
    from repro_torch.models.transformer import TransformerLM
    return TransformerLM(cfg, device)


__all__ = ["build_model"]
