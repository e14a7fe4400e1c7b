"""Architecture registry of the port: ``--arch <id>`` resolves here.

Counterpart of `repro/configs/__init__.py`. Each module defines SPEC:
configs.base.ArchSpec. `ARCH_IDS` lists every registered architecture;
`all_cells` walks the dry run's cells in the reference's order.
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
# the ten assigned architectures in the reference's order
# (`repro/configs/__init__.py:ARCH_IDS`), which `all_cells` follows
CELL_ARCH_IDS = ("llama4-maverick-400b-a17b", "moonshot-v1-16b-a3b",
                 "mistral-large-123b", "mistral-nemo-12b", "internlm2-20b",
                 "nequip", "dimenet", "pna", "gatedgcn",
                 "two-tower-retrieval")


def get_arch(arch_id: str):
    if arch_id not in _MODULES:
        raise KeyError(f"unknown or unported arch {arch_id!r}; ported: "
                       f"{sorted(_MODULES)}")
    return import_module(_MODULES[arch_id]).SPEC


def all_cells(include_extra: bool = False) -> list:
    """Every (arch, shape) cell, in the reference's order: the 40
    assigned (10 archs x 4 shapes), then the paper's own model
    (d3gnn-sage) with include_extra."""
    ids = CELL_ARCH_IDS + (("d3gnn-sage",) if include_extra else ())
    return [(a, s) for a in ids for s in get_arch(a).shapes]
