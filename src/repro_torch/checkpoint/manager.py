"""Checkpointing: atomic, one file a leaf (port of
`repro.checkpoint.manager`, in its on-disk layout, so a checkpoint
written by either package restores in the other).

Layout: <dir>/step_<N>/ manifest.json + one .npy per leaf; a leaf's key
is its tree path joined with "/" (dict keys and list indices, in the
JAX package's leaf order), its file the key with "/" replaced by "__".
Writes go to a tmp dir renamed into place (atomic on POSIX), so a crash
mid-save never corrupts the latest checkpoint; the newest `keep` steps
are kept. Arrays are stored whole and restored onto the device the
caller names.

On a mesh the tree holds a rank's blocks. `save(..., unshard=, write=)`
makes each leaf whole on every rank, one leaf at a time, and only the
writing rank (rank 0) keeps it long enough to write it, so no rank ever
holds the whole tree; `restore(..., blocks=)` reads each whole leaf and
keeps the rank's block. The files are the same either way: a checkpoint
written on a mesh restores on one device, on another mesh, and in the
JAX package, and the reverse.
"""
from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any, Callable, Optional

import numpy as np

from repro_torch import tree as T
from repro_torch.interop import to_torch


def save(ckpt_dir: str, step: int, tree: Any, keep: int = 3,
         unshard: Optional[Callable] = None, write: bool = True
         ) -> Optional[str]:
    """Atomic checkpoint write; prunes to the newest `keep` steps.
    `unshard(path, block)` makes each leaf whole first (every rank of a
    mesh calls `save`; only the one with `write` touches the disk)."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if write:
        os.makedirs(ckpt_dir, exist_ok=True)
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
    manifest = {"step": step, "leaves": {}}
    for path, leaf in T.flatten_with_path(tree):
        if unshard is not None:
            leaf = unshard(path, leaf)
        if not write:
            continue
        key = T.path_key(path)
        arr = leaf.detach().cpu().numpy()
        fname = key.replace("/", "__") + ".npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"][key] = {"file": fname, "shape": list(arr.shape),
                                   "dtype": str(arr.dtype)}
        del leaf, arr
    if not write:
        return None
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _prune(ckpt_dir, keep)
    return final


def _prune(ckpt_dir: str, keep: int) -> None:
    steps = sorted(all_steps(ckpt_dir))
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)


def all_steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        m = re.fullmatch(r"step_(\d+)", name)
        if m:
            out.append(int(m.group(1)))
    return sorted(out)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def restore(ckpt_dir: str, step: int, template: Any, device=None,
            blocks: Optional[Callable] = None) -> Any:
    """Rebuild `template`'s tree from disk, each leaf on `device` (the
    template leaf's own device when None). Leaves missing on disk keep the
    template's value (restores stay valid after new state is added).
    `blocks(path, shape)` -> slices keeps only those slices of each whole
    leaf (a rank's block; the template's leaves are blocks then)."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    out = []
    for kp, leaf in T.flatten_with_path(template):
        meta = manifest["leaves"].get(T.path_key(kp))
        if meta is None:
            out.append(leaf)
            continue
        arr = np.load(os.path.join(path, meta["file"]))
        if blocks is not None:
            arr = np.ascontiguousarray(arr[blocks(kp, arr.shape)])
        out.append(to_torch(arr, leaf.device if device is None else device))
    return T.unflatten(template, out)
