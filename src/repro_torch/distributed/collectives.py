"""SPARQ gradient compression with error feedback (port of
`repro.distributed.collectives`): the paper's windowed quantization
applied to gradients. Each tensor is quantized to int8 with a per-tensor
scale, then bSPARQ keeps a rounded signed 4-bit window with a 3-bit shift
(5opt); what the window loses is carried to the next step as a residual,
which makes the compression unbiased over time. Tensors under `min_size`
(norms, scalars) stay exact.

On a mesh the compressor works on a rank's blocks with the whole leaf's
scale (`compress(..., numels=, amax=)`), which equals compressing the
whole leaf and slicing it. The reference's cross-rank reductions run over
a `launch.mesh.DistMesh`'s axis groups: `hierarchical_psum` (the data
group, then the pod group) and `compressed_psum` (Σ over an axis of each
rank's compressed tensor)."""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Optional, Sequence, Tuple

import torch

from repro_torch import tree as T
from repro_torch.core.bsparq import bsparq_recon_signed, shifts_for
from repro_torch.core.quantizer import div_qmax
from repro_torch.distributed import comm


@functools.lru_cache(maxsize=None)
def _recon_table(bits: int, device: torch.device) -> torch.Tensor:
    """The signed windowed reconstruction of every int8 code -127..127
    (index q + 127), from `bsparq_recon_signed` itself."""
    q = torch.arange(-127, 128, dtype=torch.int32)
    return bsparq_recon_signed(q, bits, shifts_for(bits, 8 - bits + 1),
                               rounding=True).to(device)


def sparq_compress(g: torch.Tensor, bits: int = 4,
                   amax: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fake-quant SPARQ compression of one gradient tensor (per-tensor
    scale; signed windowed `bits`-bit). Returns the reconstruction, what
    the receiving side would decode. The codes' reconstructions are
    looked up in a 255-entry table of `bsparq_recon_signed`: one pass
    over the tensor instead of the codec's ≈ 40 elementwise ones. `amax`
    (0-d) sets the scale in place of max |g|: a block of a leaf takes the
    whole leaf's."""
    amax = torch.amax(torch.abs(g)) if amax is None else amax
    scale = div_qmax(torch.clamp(amax, min=1e-20), 127)
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
    def compress(self, grads: Any, state: Any,
                 numels: Optional[Sequence[int]] = None,
                 amax: Optional[Callable[[torch.Tensor], torch.Tensor]]
                 = None) -> Tuple[Any, Any]:
        """On a mesh the leaves are blocks: `numels` gives each whole
        leaf's size in leaf order (min_size is judged on it), and `amax`
        maps the vector of this rank's max |g + e| per leaf to the whole
        leaves' (an all-reduce MAX over the mesh)."""
        flat_g, flat_e = T.leaves(grads), T.leaves(state)
        sizes = [g.numel() for g in flat_g] if numels is None else numels
        big = [n >= self.min_size for n in sizes]
        scale_max = [None] * len(flat_g)
        if amax is not None:
            local = [torch.amax(torch.abs(g.to(torch.float32) + e)) if b
                     else torch.zeros((), device=e.device)
                     for g, e, b in zip(flat_g, flat_e, big)]
            scale_max = list(amax(torch.stack(local)).unbind(0))

        def one(g, e, b, m):
            if not b:
                return g, torch.zeros_like(e)
            target = g.to(torch.float32) + e
            c = sparq_compress(target, self.bits, m)
            return c.to(g.dtype), target - c.to(torch.float32)
        outs = [one(*a) for a in zip(flat_g, flat_e, big, scale_max)]
        return (T.unflatten(grads, [o[0] for o in outs]),
                T.unflatten(grads, [o[1] for o in outs]))


def hierarchical_psum(x: torch.Tensor, mesh, pod_axis: str = "pod",
                      data_axis: str = "data", site: str = "grads"
                      ) -> torch.Tensor:
    """Σ of `x` over the data group, then the pod group (two hops, the
    first inside a pod); returns a new tensor."""
    y = x.clone()
    comm.all_reduce(y, mesh.group(data_axis), site=site)
    return comm.all_reduce(y, mesh.group(pod_axis), site=site)


def compressed_psum(x: torch.Tensor, mesh, axis: str,
                    bits: int = 4) -> torch.Tensor:
    """Σ over `axis` of each rank's `sparq_compress(x)`: the quantization
    happens before the wire, and the fake-quant reconstruction keeps the
    decoded values' arithmetic exact."""
    return comm.all_reduce(sparq_compress(x, bits), mesh.group(axis),
                           site="grads")
