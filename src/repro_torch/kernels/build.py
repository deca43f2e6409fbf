"""Build and bind the hand-written CUDA kernels under `repro_torch/csrc/`.

Each `.cu` source is compiled by nvcc for `sm_90a` into a shared library
with a plain C interface (no PyTorch headers, so a build takes seconds)
and loaded with ctypes: every pointer and the stream go over as
`c_void_p`. Builds happen at first use, from the package's own sources,
into `build/kernels/` at the repository root (override with
`REPRO_TORCH_BUILD_DIR`); the library name carries a hash of the sources,
so an edited kernel is rebuilt and a stale library is never loaded.
`--use_fast_math` is never passed: it approximates `x / a` and flushes
denormals, which would change quantization codes.

`CudaKernel` keeps a plain integer launch counter per kernel: the wrapper
bumps it where, and only where, it launches the kernel, so a run can show
that its main path went through the kernels (`reset_launch_counts` /
`launch_counts`).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
from typing import Dict, List, Optional, Sequence

import torch

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
# dynamic shared memory one block may use on an H100 (227 KB)
SMEM_LIMIT = 232448
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ("-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC")


def build_dir() -> pathlib.Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return pathlib.Path(env)
    # <repo>/src/repro_torch/kernels/build.py -> <repo>/build/kernels
    return pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = pathlib.Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "source at first use and need the CUDA toolkit")


def _headers() -> List[pathlib.Path]:
    return sorted(CSRC.glob("*.cuh"))


def _lib_path(source: str) -> pathlib.Path:
    h = hashlib.sha1()
    for p in [CSRC / source, *_headers()]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    stem = pathlib.Path(source).stem
    return build_dir() / f"lib{stem}-{h.hexdigest()[:12]}.so"


def _nvcc_cmd(source: str, out: pathlib.Path, verbose: bool) -> List[str]:
    cmd = [nvcc_path(), *ARCH_FLAGS, *NVCC_FLAGS, "-I", str(CSRC),
           "-o", str(out), str(CSRC / source)]
    if verbose:
        cmd.insert(1, "-Xptxas=-v")
    return cmd


def build(sources: Sequence[str], verbose: bool = False) -> Dict[str, str]:
    """Compile every source whose library is missing, one nvcc process per
    source, all started together. Returns {source: compiler output} for
    the sources built now (ptxas register/spill lines with `verbose`).
    Raises on the first failed build."""
    build_dir().mkdir(parents=True, exist_ok=True)
    procs = {}
    for src in sources:
        out = _lib_path(src)
        if out.exists():
            continue
        tmp = out.with_name(out.name + f".{os.getpid()}.tmp")
        procs[src] = (subprocess.Popen(
            _nvcc_cmd(src, tmp, verbose), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), tmp, out)
    logs, failed = {}, []
    for src, (proc, tmp, out) in procs.items():
        text, _ = proc.communicate()
        logs[src] = text
        if proc.returncode != 0:
            failed.append(f"{src}:\n{text}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return logs


class CudaKernel:
    """One hand-written kernel: its source, C entry point, and counter.

    `launch(*args)` calls the C entry point (which launches on the stream
    passed as its last argument and returns `cudaGetLastError()`), raises
    if that is non-zero, and counts the launch."""

    def __init__(self, name: str, source: str, symbol: str,
                 argtypes: Sequence, replaces: str):
        self.name = name
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.replaces = replaces
        self.launches = 0
        self._fn = None
        self._err = None
        self._lock = threading.Lock()
        KERNELS[name] = self

    def _bind(self):
        with self._lock:
            if self._fn is None:
                build([self.source])
                lib = ctypes.CDLL(str(_lib_path(self.source)))
                fn = getattr(lib, self.symbol)
                fn.argtypes = self.argtypes
                fn.restype = ctypes.c_int
                err = lib.sparq_error_string
                err.argtypes = [ctypes.c_int]
                err.restype = ctypes.c_char_p
                self._fn, self._err = fn, err
        return self._fn

    def launch(self, *args) -> None:
        fn = self._bind()
        rc = fn(*args)
        if rc != 0:
            raise RuntimeError(
                f"CUDA kernel {self.name} failed to launch: error {rc} "
                f"({self._err(rc).decode()})")
        self.launches += 1


KERNELS: Dict[str, CudaKernel] = {}


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0


def launch_counts() -> Dict[str, int]:
    return {name: k.launches for name, k in KERNELS.items()}


def build_all(verbose: bool = False) -> Dict[str, str]:
    """Build every registered kernel's library in parallel (set-up time)."""
    return build(sorted({k.source for k in KERNELS.values()}), verbose)


def stream_ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def ptr(t: Optional[torch.Tensor]) -> ctypes.c_void_p:
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


def check(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple,
          device: torch.device) -> None:
    """Raise unless `t` has exactly this dtype, shape, device, layout."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
