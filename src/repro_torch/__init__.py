"""PyTorch/CUDA port of the LLHR planner for NVIDIA Hopper (H100).

A second package beside ``repro`` (the JAX reference).  It imports
``torch`` and ``numpy`` only.  The layout mirrors ``repro`` module for
module; the batched planning tick (``core.rollout.make_plan_fn``), the
scenario engine and the fleet rollout run on the card, with the link
geometry and the chain-DP wavefront step as hand-written CUDA kernels
(``kernels/``, sources in ``csrc/``).  So does the paper's distributed
CNN inference: ``core.planner.LLHRPlanner`` plans, and
``models.cnn.distributed_forward`` runs each request sliced by its
placement, its conv layers through a hand-written GEMM kernel.

Entry points take ``device=None``, which means ``"cuda"``: without a GPU
they raise.  The CPU runs only when the caller passes ``device="cpu"``.
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
