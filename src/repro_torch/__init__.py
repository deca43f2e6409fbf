"""PyTorch/CUDA port of the SPARQ serving stack (`repro` is the JAX original).

The package imports torch and numpy only. Plain tensor code runs on any
device; the six kernels of the JAX package (quantized matmul, paged and
contiguous flash-decode, chunked-prefill attention, the KV-write quantizer
and the KV read-back meta-decode) are hand-written CUDA C++ for Hopper
under `csrc/`, built with nvcc at first use. Dispatch goes by the device of the
tensors: CPU tensors take the plain PyTorch versions, CUDA tensors take
the kernels, anything else raises.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: `cuda` unless the caller asks
    for another. Raises when no GPU is present and none was asked for —
    the port never falls back to the CPU silently."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' explicitly to "
                "run the plain PyTorch versions on the CPU")
        return torch.device("cuda")
    return torch.device(device)
