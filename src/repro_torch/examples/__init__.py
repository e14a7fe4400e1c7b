"""The JAX package's four examples as the port's entry points.

Counterparts of `examples/quickstart.py`, `streaming_serve.py`,
`train_streaming_gnn.py` and `arch_zoo.py`, with the same flags, sizes,
seeds, printed lines and asserts, plus --device (CUDA unless given) and,
where the JAX example reads its device count from XLA_FLAGS, --ranks N:
N gloo ranks on this host (`launch/mesh.py:spawn_stream_mesh`), on a
('stage', 'data') grid with --stage S.

    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu
    PYTHONPATH=src python -m repro_torch.examples.quickstart --stage 2
    PYTHONPATH=src python -m repro_torch.examples.train_streaming_gnn
    PYTHONPATH=src python -m repro_torch.examples.streaming_serve --ranks 4
    PYTHONPATH=src python -m repro_torch.examples.arch_zoo --arch all

Each example's body is a function `run(args, ...)` that the CLI calls
(with `mesh=`, this rank's view of a mesh, where the example takes
--ranks). Its optional parameters take a model's `state_dict` (the JAX
example's parameters through `repro_torch.convert`, in the tests); left
out, the weights come from a seeded `torch.Generator`. It returns its
`Say`: the lines it printed and the full-precision values behind them.
"""
from __future__ import annotations


class Say:
    """print() on one device or on rank 0 of a mesh, keeping each printed
    line (`lines`) and the unrounded numbers behind them (`values`)."""

    def __init__(self, mesh=None):
        self.on = mesh is None or mesh.rank == 0
        self.lines: list = []
        self.values: dict = {}

    def __call__(self, line: str) -> None:
        if self.on:
            print(line, flush=True)
            self.lines.append(line)

    def keep(self, key: str, value) -> None:
        """Append `value` to the list of values kept under `key`."""
        self.values.setdefault(key, []).append(value)


def add_device_args(ap, ranks: bool = False) -> None:
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without it)")
    if ranks:
        ap.add_argument("--ranks", type=int, default=None,
                        help="gloo ranks of the mesh, as many as the JAX "
                             "example's devices (default: --stage)")


def _on_rank(mesh, body, args, *extra):
    return body(args, mesh, *extra)


def launch(body, args, *extra):
    """body(args, mesh, *extra) on one device when --ranks and --stage are
    1, else on --ranks gloo ranks of this host (every rank on the device
    --device names; cuda means cuda:0); returns the body's result, rank
    0's on a mesh."""
    from repro_torch.device import resolve_device
    from repro_torch.launch.mesh import spawn_stream_mesh
    device = resolve_device(args.device)
    stage = getattr(args, "stage", 1)
    n = getattr(args, "ranks", None) or stage
    if n == 1 and stage == 1:
        return body(args, None, *extra)
    return spawn_stream_mesh(n, _on_rank, backend="gloo", device=str(device),
                             stage=stage, args=(body, args, *extra))[0]
