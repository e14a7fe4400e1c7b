"""Architecture registry of the port: ``--arch <id>`` resolves here.

Counterpart of `repro/configs/__init__.py`, over the architectures ported
so far. Each module defines SPEC: configs.base.ArchSpec.
"""
from __future__ import annotations

from importlib import import_module

_MODULES = {
    "mistral-nemo-12b": "repro_torch.configs.mistral_nemo_12b",
    "d3gnn-sage": "repro_torch.configs.d3gnn_sage",
    "two-tower-retrieval": "repro_torch.configs.two_tower_retrieval",
    "nequip": "repro_torch.configs.nequip",
    "dimenet": "repro_torch.configs.dimenet",
    "pna": "repro_torch.configs.pna",
    "gatedgcn": "repro_torch.configs.gatedgcn",
    "moonshot-v1-16b-a3b": "repro_torch.configs.moonshot_v1_16b_a3b",
    "llama4-maverick-400b-a17b":
        "repro_torch.configs.llama4_maverick_400b_a17b",
    "internlm2-20b": "repro_torch.configs.internlm2_20b",
    "mistral-large-123b": "repro_torch.configs.mistral_large_123b",
}
ARCH_IDS = tuple(_MODULES)


def get_arch(arch_id: str):
    if arch_id not in _MODULES:
        raise KeyError(f"unknown or unported arch {arch_id!r}; ported: "
                       f"{sorted(_MODULES)}")
    return import_module(_MODULES[arch_id]).SPEC
