"""The models on the D3-GNN engine, one module each, found by the name a
configuration gives under `model_module`."""
from __future__ import annotations

import importlib.util
from pathlib import Path

HERE = Path(__file__).resolve().parent


def load(name: str):
    """The model module `<name>.py` of this directory."""
    spec = importlib.util.spec_from_file_location(
        f"portbench_model_{name}", HERE / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
