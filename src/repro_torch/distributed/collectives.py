"""SPARQ gradient compression with error feedback (port of
`repro.distributed.collectives`): the paper's windowed quantization
applied to gradients. Each tensor is quantized to int8 with a per-tensor
scale, then bSPARQ keeps a rounded signed 4-bit window with a 3-bit shift
(5opt); what the window loses is carried to the next step as a residual,
which makes the compression unbiased over time. Tensors under `min_size`
(norms, scalars) stay exact.

The cross-device reductions of the reference (`hierarchical_psum`,
`compressed_psum`) are not ported: they wait for tensor parallelism over
`torch.distributed`."""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Tuple

import torch

from repro_torch import tree as T
from repro_torch.core.bsparq import bsparq_recon_signed, shifts_for
from repro_torch.core.quantizer import div_qmax


@functools.lru_cache(maxsize=None)
def _recon_table(bits: int, device: torch.device) -> torch.Tensor:
    """The signed windowed reconstruction of every int8 code -127..127
    (index q + 127), from `bsparq_recon_signed` itself."""
    q = torch.arange(-127, 128, dtype=torch.int32)
    return bsparq_recon_signed(q, bits, shifts_for(bits, 8 - bits + 1),
                               rounding=True).to(device)


def sparq_compress(g: torch.Tensor, bits: int = 4) -> torch.Tensor:
    """Fake-quant SPARQ compression of one gradient tensor (per-tensor
    scale; signed windowed `bits`-bit). Returns the reconstruction, what
    the receiving side would decode. The codes' reconstructions are
    looked up in a 255-entry table of `bsparq_recon_signed`: one pass
    over the tensor instead of the codec's ≈ 40 elementwise ones."""
    scale = div_qmax(torch.clamp(torch.amax(torch.abs(g)), min=1e-20), 127)
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int32)
    r = torch.index_select(_recon_table(bits, g.device), 0,
                           (q + 127).reshape(-1)).reshape(q.shape)
    return r.to(g.dtype) * scale


@dataclasses.dataclass
class GradCompressor:
    """Error-feedback SPARQ gradient compression. The state is a residual
    tree shaped as the gradients (f32 zeros at init);
    `compress(grads, state) -> (compressed_grads, new_state)`."""
    bits: int = 4
    min_size: int = 4096   # tiny tensors (norms, scalars) stay exact

    def init(self, grads: Any) -> Any:
        return T.tree_map(lambda g: torch.zeros_like(g, dtype=torch.float32),
                          grads)

    @torch.no_grad()
    def compress(self, grads: Any, state: Any) -> Tuple[Any, Any]:
        def one(g, e):
            if g.numel() < self.min_size:
                return g, torch.zeros_like(e)
            target = g.to(torch.float32) + e
            c = sparq_compress(target, self.bits)
            return c.to(g.dtype), target - c.to(torch.float32)
        outs = [one(g, e) for g, e in zip(T.leaves(grads), T.leaves(state))]
        return (T.unflatten(grads, [o[0] for o in outs]),
                T.unflatten(grads, [o[1] for o in outs]))
