"""Kernel entries by name: `yardstick/kernels/<entry>.py`, one file a
program entry that launches hand-written kernels. Each file holds

  TARGET          (module, attribute) of the program's entry;
  KERNELS         the device kernels it launches, as the profiler names
                  them;
  log(args)       from one call's bound arguments: (static shape facts,
                  a 1-D tensor of device scalars, read only after the
                  window), or None for a call that is not logged;
  launch_bytes(static, values)  the bytes the launch must move: each
                  input byte read once, each output byte written once.

A new kernel is a new file here and a `<kernel>_roofline` reader that
calls `roofline_share` with the file's name.
"""
from __future__ import annotations

import importlib
import importlib.util
from pathlib import Path

HERE = Path(__file__).resolve().parent / "kernels"


def entries() -> dict:
    """{name: module} of every entry file here."""
    out = {}
    for path in sorted(HERE.glob("*.py")):
        spec = importlib.util.spec_from_file_location(
            f"portbench_kernel_{path.stem}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        out[path.stem] = mod
    return out


def target(entry):
    """The module that holds the entry's program function. Raises where
    the program no longer has it, so that a kernel renamed or moved does
    not lose its roofline unseen: a kernel taken off the program goes
    with its entry file."""
    module, attr = entry.TARGET
    mod = importlib.import_module(module)
    if not callable(getattr(mod, attr, None)):
        raise LookupError(f"kernel entry {Path(entry.__file__).name}: the "
                          f"program has no {module}.{attr}")
    return mod


def roofline_share(ctx, name: str):
    """% of the least time (bytes / peak HBM rate) the entry's launches in
    the profiled window could take, over their measured device time; None
    where the window has none."""
    from portbench.yardstick import peaks
    t = ctx.trace
    if not t or name not in ctx.kernels:
        return None
    kernels = entries()[name].KERNELS
    measured = sum(s for n, s in t["by_name_s"].items()
                   if any(k in n for k in kernels))
    if not measured:
        return None
    return 100.0 * ctx.kernels[name][0] / peaks.BYTES_PER_S / measured
