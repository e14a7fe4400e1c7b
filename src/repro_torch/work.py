"""Notes of work that no dispatch mode can price on its own.

A hand-written kernel is a ctypes launch that a `TorchDispatchMode`
never sees, and a plain causal attention's products over masked (query,
key) pairs are work its function does not need. Each such site calls
`note(name, **operands)` where the work happens; an observer, the
roofline's `op_analyzer.OpCounter` while it counts, prices the note
from its own table (`op_analyzer.NOTE_COSTS`), so the sites carry no
cost formula. With no observer, `note` is one check.
"""
from __future__ import annotations

# the active observers, innermost last: each is called as
# observer(name, operands)
OBSERVERS: list = []


def note(name: str, **operands) -> None:
    """Tell the innermost observer that `name` ran on `operands`."""
    if OBSERVERS:
        OBSERVERS[-1](name, operands)
