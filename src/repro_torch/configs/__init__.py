"""Config registry of the port: the architectures ported so far, by the
names the JAX package uses (`repro.configs.base`). As there, the paper's
CNN is registered but left out of `ARCHS`, the decoders the serve CLI
offers."""
from __future__ import annotations

import importlib
from typing import Dict

_REGISTRY: Dict[str, str] = {
    "tinyllama-1.1b": "repro_torch.configs.tinyllama_1_1b",
    "granite-20b": "repro_torch.configs.granite_20b",
    "starcoder2-3b": "repro_torch.configs.starcoder2_3b",
    "mistral-large-123b": "repro_torch.configs.mistral_large_123b",
    "paper-resnet": "repro_torch.configs.paper_resnet",  # paper's own family
}

ARCHS = tuple(k for k in _REGISTRY if k != "paper-resnet")


def _module(name: str):
    if name not in _REGISTRY:
        raise KeyError(f"architecture {name!r} is not ported yet "
                       f"(ported: {', '.join(_REGISTRY)})")
    return importlib.import_module(_REGISTRY[name])


def get_config(name: str):
    return _module(name).config()


def get_reduced_config(name: str):
    return _module(name).reduced()
