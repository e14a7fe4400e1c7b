"""Fault tolerance (counterpart of `repro/ft`): consistent-cut
checkpointing of the whole pipeline (in-flight windows and held queries
included), the Alg. 5 rescale plan and local recovery, straggler
detection, and the chaos drills (`ft/chaos.py`, imported on its own)."""
from repro_torch.ft.checkpoint import CheckpointManager  # noqa: F401
from repro_torch.ft.elastic import rescale_parts  # noqa: F401
from repro_torch.ft.stragglers import StragglerMitigator  # noqa: F401
