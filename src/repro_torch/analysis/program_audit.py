"""Invariant auditor for the registered hot programs (port of
`repro.analysis.jaxpr_audit`).

PyTorch has no jaxpr to walk, so a program is audited by running it: each
hot program (decode step, paged step, prefill chunk, replay, the
`kernels/ops.py` dispatchers) is called once per entry of its shape set,
on small real tensors, under a recorder. A `TorchFunctionMode` sees every
host read the program makes, a `TorchDispatchMode` the dtype of every
aten op's inputs and outputs, and the dispatchers report each launch they
ask of a kernel through `kernels.ops.AUDIT_HOOK`, whose launch plan is
then evaluated by the kernel's own plan functions. The check IDs are the
reference's:

JX101  no host read inside a hot program: `item`, `tolist`, `numpy`,
       `__bool__` / `__int__` / `__float__` / `__index__` / `__array__` /
       `__repr__`, `cpu` or `to` from the card to the host,
       `torch.cuda.synchronize`, and any `aten._local_scalar_dense` (a
       scalar read that torch makes for the caller). A step that reads
       the device cannot be captured as a CUDA graph and serializes every
       step on a round trip. A read made inside a kernel's plain version
       (a `ref_*` function of `repro_torch/kernels/`) runs on the CPU
       route only: it is counted apart ("plain_route_reads") and is no
       finding; the audit on the card settles the kernels' route.
JX102  a packed int8 / uint8 plane becomes float only inside a kernel
       call (`kernels.ops.META_DECODE_SOURCES`): every int8 / uint8
       tensor is tainted, the taint rides every aten op with an integer
       output (so a widening to int32 before the cast is still caught),
       and an op with a tainted input and a floating output is flagged
       unless a frame of the stack lies under a meta-decode source (the
       kernels' wrappers and their plain versions). Ops that read only a
       tainted tensor's shape (`empty_like`, `new_zeros`, ...) are not
       casts.
JX103  every tile of a kernel's launch plan that its CUDA body does not
       mask divides the dimension it tiles. From the sources:
         K1 sparq_matmul.cu masks its ragged M, N and K edges; only the
            vSPARQ lane pair (2 lanes) must divide K.
         K4 sparq_quant.cu and K6 sparq_dequant.cu walk their rows in a
            grid-stride loop with a scalar tail; only the lane pair must
            divide each row's width and the head shard's first lane.
         K2 / K5 (sparq_decode_common.cuh) cut the keys into splits of
            whole tiles and mask the ragged last tile and split; K2's
            tile is the page, which divides its NB * page keys.
         K3 sparq_chunked_prefill_attn.cu masks its page and chunk key
            tiles and a query tile's row blocks (r < bq * G); the query
            tile of bq stream rows must divide the chunk C.
         K7 sparq_mla_decode.cu masks the ragged last tile; its plan
            cuts any n_keys into at most 16 splits a batch row.
       A shape that no instantiation takes (K3's `k3_traits` raises) is
       reported here too.
JX104  in a program that declares `page_size`, a paged read's key tile is
       the page: K2's and K3's pools are tiled by pages of that size, and
       K5, where a program that declares it reads contiguous planes (the
       replay), takes tiles of exactly one page (`attn_bk ==
       page_size`), so it reads the bytes as the paged kernel did.
JX105  a launch's shared memory stays under the budget (default
       `kernels.build.SMEM_LIMIT`, an H100's 227 KB a block): K1's
       `smem_bytes(plan)`, K2 / K5's and K3's `smem_bytes`, K7's
       `smem_bytes` (fixed by r and dr: H, B and n_keys change its grid
       and its runs of tiles, not a block).
JX106  running a program over its shape set gives ONE `call_signature`:
       the condition under which one captured CUDA graph serves every
       call.

The recorder takes a frame off the stack only where an op can be a
finding (a read, a tainted float, a launch), so the audit of every
registered program stays a few seconds on one CPU worker.
"""
from __future__ import annotations

import dataclasses
import os
import sys
import sysconfig
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch import tree as T
from repro_torch.analysis.findings import (Finding, JX_COMPILE_CACHE,
                                           JX_HOSTCALL, JX_PACKED_CAST,
                                           JX_PAGE_TILE, JX_TILE_DIVIDE,
                                           JX_VMEM)
from repro_torch.kernels import ops
from repro_torch.kernels import sparq_decode_attn as _dec
from repro_torch.kernels import sparq_matmul as _mm
from repro_torch.kernels import sparq_mla_decode as _mla
from repro_torch.kernels import sparq_prefill_attn as _pre
from repro_torch.kernels.build import SMEM_LIMIT

#: SMs of the card whose launch plans the CPU run evaluates (an H100 SXM);
#: on the card the plans take the device's own count
PLAN_SMS = 132

_PACKED = (torch.int8, torch.uint8)
_INTEGER = (torch.int8, torch.uint8, torch.int16, torch.int32, torch.int64)

_T = torch.Tensor
_READS = {_T.item, _T.tolist, _T.numpy, _T.__bool__, _T.__int__,
          _T.__float__, _T.__index__, _T.__complex__, _T.__array__,
          _T.__repr__, _T.__format__}
_MOVES = {_T.cpu, _T.to}
_aten = torch.ops.aten
# ops that read only a tensor's metadata: no decode whatever the dtype
_SHAPE_ONLY = {_aten.empty_like, _aten.zeros_like, _aten.ones_like,
               _aten.full_like, _aten.rand_like, _aten.randn_like,
               _aten.new_empty, _aten.new_zeros, _aten.new_ones,
               _aten.new_full, _aten.new_empty_strided}

_HERE = os.path.dirname(os.path.abspath(__file__))
_TORCH = os.path.dirname(os.path.abspath(torch.__file__))
_LIBS = tuple({_TORCH, _HERE} | {sysconfig.get_paths()[k] for k in
                                  ("stdlib", "platstdlib", "purelib",
                                   "platlib")})
_KERNELS = os.sep + os.path.join("repro_torch", "kernels") + os.sep
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(_HERE)))


@dataclasses.dataclass
class ProgramSpec:
    """One registered hot program.

    `shape_set` is a list of argument tuples of small real tensors (or
    zero-argument makers of them, called outside the recorder), mirroring
    what the live engine feeds the program: each entry is run once under
    the recorder, and the entries' `call_signature`s drive JX106.
    `audit_cache=False` opts a program out of JX106 (the replay runs per
    recorded-token count, a cold path once per preemption). `page_size`
    declares the program's page (JX104)."""
    name: str
    fn: Callable
    shape_set: Sequence
    page_size: Optional[int] = None
    audit_cache: bool = True


# ----------------------------------------------------------------------
# call signatures
# ----------------------------------------------------------------------

def _as_tree(x):
    """x with dataclasses and named tuples as dicts (their type named)
    and every dict keyed by strings, so that `tree.flatten_with_path`
    walks it."""
    if isinstance(x, (torch.Tensor, np.ndarray)):
        return x
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {"<type>": type(x).__qualname__,
                **{f.name: _as_tree(getattr(x, f.name))
                   for f in dataclasses.fields(x)}}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return {"<type>": type(x).__qualname__,
                **{k: _as_tree(v) for k, v in zip(x._fields, x)}}
    if isinstance(x, dict):
        return {repr(k): _as_tree(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_as_tree(v) for v in x)
    return x


def call_signature(args: tuple, kwargs: Optional[dict] = None) -> tuple:
    """The identity of a call as one captured CUDA graph would serve it:
    the argument tree's structure (dict keys, sequence positions, the
    types of dataclasses and named tuples), each tensor's shape, dtype
    and device, each host array's shape and dtype, and the repr of every
    other leaf (a static value). Two calls with equal signatures can
    replay one graph."""
    paths, sig = [], []
    for path, leaf in T.flatten_with_path(_as_tree((tuple(args),
                                                    kwargs or {}))):
        paths.append(path)
        if isinstance(leaf, torch.Tensor):
            sig.append(("tensor", tuple(leaf.shape), str(leaf.dtype),
                        str(leaf.device)))
        elif isinstance(leaf, np.ndarray):
            sig.append(("array", leaf.shape, str(leaf.dtype)))
        else:
            sig.append(("static", repr(leaf)))
    return (tuple(paths), tuple(sig))


# ----------------------------------------------------------------------
# the recorder
# ----------------------------------------------------------------------

def _user_frames():
    """The stack's frames outside torch, this package, the standard
    library and installed packages, innermost first."""
    f, out = sys._getframe(2), []
    while f is not None:
        fn = f.f_code.co_filename
        if not (fn.startswith(_LIBS) or fn.startswith("<")):
            out.append(f)
        f = f.f_back
    return out


def _rel(path: str) -> str:
    path = os.path.abspath(path)
    return os.path.relpath(path, _ROOT) if path.startswith(_ROOT) else path


def _anchor(frames, skip: str = "") -> Tuple[str, int]:
    """(file, line) of the innermost user frame not in `skip`: a line of
    `src/repro_torch/` for the port's programs."""
    for f in frames:
        if not (skip and f.f_code.co_filename.endswith(skip)):
            return _rel(f.f_code.co_filename), f.f_lineno
    return "", 0


def _in_plain_version(frames) -> bool:
    return any(_KERNELS in f.f_code.co_filename
               and f.f_code.co_name.startswith("ref_") for f in frames)


def _tensors(tree) -> List[torch.Tensor]:
    out = []
    for v in tree:
        if isinstance(v, torch.Tensor):
            out.append(v)
        elif isinstance(v, (list, tuple)):
            out.extend(t for t in v if isinstance(t, torch.Tensor))
    return out


def _to_host(func, args, kwargs) -> bool:
    """A `cpu()` or `to(...)` that copies a card tensor to the host."""
    src = args[0] if args else None
    if not isinstance(src, torch.Tensor) or src.device.type == "cpu":
        return False
    if func is _T.cpu:
        return True
    dev = kwargs.get("device")
    for a in args[1:]:
        if isinstance(a, (str, torch.device)):
            dev = a
        elif isinstance(a, torch.Tensor):
            dev = a.device
    return dev is not None and torch.device(dev).type == "cpu"


class _Recorder:
    """The findings and tallies of one program's runs."""

    def __init__(self, program: str, page_size: Optional[int],
                 smem_budget: int, meta_sources: Tuple[str, ...]):
        self.program, self.page_size = program, page_size
        self.smem_budget = smem_budget
        self.meta_sources = tuple(s.replace("/", os.sep)
                                  for s in meta_sources)
        self.findings: List[Finding] = []
        self._seen = set()
        self.plain_reads = 0
        self.dispatches = 0
        self.taint = WeakIdKeyDictionary()
        self.reading = 0

    def emit(self, check: str, where: Tuple[str, int], message: str):
        key = (check, where, message)
        if key in self._seen:
            return
        self._seen.add(key)
        self.findings.append(Finding(check=check, file=where[0],
                                     line=where[1], program=self.program,
                                     message=message))

    # ------------------------------------------------------------ JX101
    def host_read(self, what: str) -> None:
        frames = _user_frames()
        if _in_plain_version(frames):
            self.plain_reads += 1
            return
        self.emit(JX_HOSTCALL, _anchor(frames),
                  f"host read `{what}` inside a hot program: every step "
                  f"would wait on a device round trip, and no CUDA graph "
                  f"can capture it")

    # ------------------------------------------------------------ JX102
    def tainted(self, t: torch.Tensor) -> bool:
        return t.dtype in _PACKED or t in self.taint

    def dtype_flow(self, func, args, kwargs, out) -> None:
        ins = _tensors(args) + _tensors(kwargs.values())
        if not any(self.tainted(t) for t in ins):
            return
        outs = _tensors(out if isinstance(out, (list, tuple)) else (out,))
        if func.overloadpacket not in _SHAPE_ONLY and any(
                o.is_floating_point() for o in outs):
            frames = _user_frames()
            if not any(s in f.f_code.co_filename for s in self.meta_sources
                       for f in frames):
                src = next(t.dtype for t in ins if self.tainted(t))
                dst = next(o.dtype for o in outs if o.is_floating_point())
                self.emit(JX_PACKED_CAST, _anchor(frames),
                          f"packed plane {src} -> {dst} by `{func}` outside "
                          f"a kernel and the meta-decode sources: decode "
                          f"must stream packed bytes, not materialize a "
                          f"float cache")
        for o in outs:
            if o.dtype in _INTEGER:
                self.taint[o] = True

    # ------------------------------------------------------ JX103-JX105
    def launch(self, kernel: str, **geo) -> None:
        self.dispatches += 1
        bad = plan_checks(kernel, geo, self.page_size, self.smem_budget)
        if bad:
            where = _anchor(_user_frames(),
                            skip=os.path.join("kernels", "ops.py"))
            for check, message in bad:
                self.emit(check, where, f"{kernel}: {message}")


def _pairs(widths, lane0=0) -> List[Tuple[str, str]]:
    out = [(JX_TILE_DIVIDE, f"the vSPARQ lane pair (2 lanes) does not "
                            f"divide a row of {w} lanes") for w in widths
           if w % 2]
    if lane0 % 2:
        out.append((JX_TILE_DIVIDE, f"a head shard starts at lane {lane0}, "
                                    f"inside a lane pair"))
    return out


def _smem(need: int, budget: int, what: str) -> List[Tuple[str, str]]:
    if need > budget:
        return [(JX_VMEM, f"{what} takes {need} B of shared memory a "
                          f"block, over the budget of {budget} B")]
    return []


def plan_checks(kernel: str, geo: Dict, page_size: Optional[int],
                smem_budget: int = SMEM_LIMIT) -> List[Tuple[str, str]]:
    """(check, message) of every JX103-JX105 violation of one launch of
    `kernel` with the geometry its dispatcher reports, evaluated by the
    kernel's own plan functions (module docstring)."""
    out: List[Tuple[str, str]] = []
    if kernel == "sparq_matmul":
        dev = geo["device"]
        sms = _mm.sm_count(dev) if dev.type == "cuda" else PLAN_SMS
        p = _mm.plan(geo["M"], geo["N"], geo["K"], sms)
        out += _pairs((geo["K"],))
        out += _smem(_mm.smem_bytes(p), smem_budget,
                     f"the {p.bm} x {p.bn} x {p.bk} tile plan")
    elif kernel == "sparq_quant":
        out += _pairs(geo["widths"], geo["lane0"])
    elif kernel == "sparq_dequant":
        out += _pairs((geo["K"],))
    elif kernel in ("sparq_decode_attn", "sparq_paged_decode_attn"):
        paged = kernel == "sparq_paged_decode_attn"
        tile = geo["page"] if paged else geo["tile"]
        n_keys = geo["NB"] * geo["page"] if paged else geo["n_keys"]
        if paged and n_keys % _dec.split_geometry(n_keys, tile).tile:
            out.append((JX_TILE_DIVIDE, f"the page tile {tile} does not "
                                        f"divide {n_keys} keys"))
        if page_size is not None and tile != page_size:
            what = "pool's page" if paged else "key tile (attn_bk)"
            out.append((JX_PAGE_TILE, f"the {what} is {tile} keys but the "
                                      f"program's page_size is "
                                      f"{page_size}: a paged read must "
                                      f"tile whole pages"))
        out += _smem(_dec.smem_bytes(geo["G"], geo["hd"], tile),
                     smem_budget, f"a split of {tile}-key tiles at G "
                                  f"{geo['G']}, hd {geo['hd']}")
    elif kernel == "sparq_chunked_prefill_attn":
        C, bq, ps = geo["C"], geo["bq"], geo["page"]
        if C % bq:
            out.append((JX_TILE_DIVIDE, f"the query tile of {bq} rows "
                                        f"does not divide the chunk of "
                                        f"{C}"))
        if page_size is not None and ps != page_size:
            out.append((JX_PAGE_TILE, f"the pool's page is {ps} keys but "
                                      f"the program's page_size is "
                                      f"{page_size}"))
        try:
            tr = _pre.k3_traits(geo["hd"], geo["G"], bq, ps)
        except ValueError as e:
            out.append((JX_TILE_DIVIDE, f"no instantiation tiles it: {e}"))
        else:
            out += _smem(_pre.smem_bytes(tr.hd, tr.rows // 16, C,
                                         geo["NB"], ps), smem_budget,
                         f"instantiation hd {tr.hd} x {tr.rows} rows over "
                         f"{geo['NB']} pages of {ps} and a chunk of {C}")
    elif kernel == "sparq_mla_decode":
        r, dr = geo["r"], geo["dr"]
        try:
            _mla.instance(r, dr)
        except ValueError as e:
            out.append((JX_TILE_DIVIDE, f"no instantiation tiles it: {e}"))
        else:
            out += _smem(_mla.smem_bytes(r, dr), smem_budget,
                         f"a block of {_mla.TILE}-key tiles at r {r}, dr "
                         f"{dr}")
    else:
        raise ValueError(f"no launch plan known for kernel {kernel!r}")
    return out


class _Reads(TorchFunctionMode):
    def __init__(self, rec: _Recorder):
        super().__init__()
        self.rec = rec

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _READS or (func in _MOVES
                              and _to_host(func, args, kwargs)):
            self.rec.host_read(func.__name__)
            self.rec.reading += 1
            try:
                return func(*args, **kwargs)
            finally:
                self.rec.reading -= 1
        return func(*args, **kwargs)


class _Flow(TorchDispatchMode):
    def __init__(self, rec: _Recorder):
        super().__init__()
        self.rec = rec

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func is _aten._local_scalar_dense.default and not self.rec.reading:
            self.rec.host_read("aten._local_scalar_dense")
        self.rec.dtype_flow(func, args, kwargs, out)
        return out


class _Recording:
    """Context: the recorder's modes, the dispatchers' hook and a
    recording `torch.cuda.synchronize`, all undone on exit."""

    def __init__(self, rec: _Recorder):
        self.rec = rec

    def __enter__(self):
        rec = self.rec
        self.sync = torch.cuda.synchronize

        def sync(*a, **k):
            rec.host_read("torch.cuda.synchronize")
            return self.sync(*a, **k)
        torch.cuda.synchronize = sync
        ops.AUDIT_HOOK = rec.launch
        self.modes = [_Reads(rec), _Flow(rec)]
        for m in self.modes:
            m.__enter__()
        return rec

    def __exit__(self, *exc):
        for m in reversed(self.modes):
            m.__exit__(*exc)
        ops.AUDIT_HOOK = None
        torch.cuda.synchronize = self.sync


# ----------------------------------------------------------------------
# the audit
# ----------------------------------------------------------------------

def audit_program(spec: ProgramSpec, *, smem_budget: int = SMEM_LIMIT,
                  meta_decode_sources: Optional[Tuple[str, ...]] = None,
                  stats: Optional[dict] = None
                  ) -> Tuple[List[Finding], int]:
    """Audit one hot program: run it on every entry of its shape set under
    the recorder, and count the call signatures those entries give.
    Returns (findings, n_signatures); `stats`, when given, receives the
    program's plain-route reads and dispatcher calls recorded."""
    if meta_decode_sources is None:
        meta_decode_sources = ops.META_DECODE_SOURCES
    if not spec.shape_set:
        raise ValueError(f"program {spec.name}: empty shape_set")
    rec = _Recorder(spec.name, spec.page_size, smem_budget,
                    meta_decode_sources)
    sigs = set()
    for entry in spec.shape_set:
        args = entry() if callable(entry) else entry
        sigs.add(call_signature(args))
        with torch.no_grad(), _Recording(rec):
            spec.fn(*args)
    if spec.audit_cache and len(sigs) > 1:
        rec.findings.append(Finding(
            check=JX_COMPILE_CACHE, file="", line=0, program=spec.name,
            message=f"{len(sigs)} distinct call signatures across the "
                    f"engine's shape set ({len(spec.shape_set)} calls): a "
                    f"hot program must take one, for one CUDA graph to "
                    f"serve every call"))
    if stats is not None:
        stats.update(plain_route_reads=rec.plain_reads,
                     dispatches=rec.dispatches)
    return rec.findings, len(sigs)


def audit_all(specs: Sequence[ProgramSpec], *,
              smem_budget: int = SMEM_LIMIT
              ) -> Tuple[List[Finding], dict]:
    """Audit every registered program. Returns (findings, counters):
    {"programs_traced": N, "signatures_per_program": {name: n},
    "plain_route_reads": {name: n}, "dispatches_per_program": {name: n}}
    (the `kernels/ops.py` dispatcher calls that reported a launch plan
    through `AUDIT_HOOK`, on either route: one a call, though a call may
    launch more than one kernel, as K4's two-pass write does; the card's
    launches are `kernels.build.launch_counts`)."""
    findings: List[Finding] = []
    sigs, plain, dispatches = {}, {}, {}
    for spec in specs:
        st: dict = {}
        fs, n = audit_program(spec, smem_budget=smem_budget, stats=st)
        findings.extend(fs)
        sigs[spec.name] = n
        plain[spec.name] = st["plain_route_reads"]
        dispatches[spec.name] = st["dispatches"]
    return findings, {"programs_traced": len(specs),
                      "signatures_per_program": sigs,
                      "plain_route_reads": plain,
                      "dispatches_per_program": dispatches}
