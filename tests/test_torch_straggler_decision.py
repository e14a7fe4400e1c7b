"""`D3Pipeline.mitigate_stragglers` takes one decision for the whole mesh.

Each rank of a port mesh feeds its own `StragglerMitigator` its own wall
clock, so a wall spike on one rank raises flags on that rank alone. JAX
decides once, in its one host process; the port's ranks must agree in the
same way, or some would enter the reshard's collectives without the
others. Four gloo CPU ranks feed their mitigators one baseline, then only
one rank sees a run of slow walls: when it is not the mesh's first rank
every rank returns None, and when it is every rank returns the same plan.
A split would hang the mesh, which `spawn_stream_mesh`'s timeout turns
into a failure.
"""
import numpy as np

from repro_torch.ft import chaos as tchaos
from repro_torch.ft.stragglers import StragglerMitigator
from repro_torch.launch.mesh import make_stream_mesh, spawn_stream_mesh

N_RANKS, TIMEOUT = 4, 180
SLOW = tchaos.ChaosConfig().slow_shard


def _plan(plan):
    return None if plan is None else (plan.old_parallelism,
                                      plan.new_parallelism, plan.moves)


def _decide_rank(world):
    cfg = tchaos.ChaosConfig()
    pipe = tchaos.build_pipeline(cfg, make_stream_mesh(world.device),
                                 telemetry=True)
    out = {}
    for spiker in (2, 0):           # a later rank first: it changes nothing
        pipe.straggler = StragglerMitigator(n_shards=pipe._n_data)
        busy = np.ones(pipe._n_data)
        busy[SLOW] = 2.0
        for _ in range(4):
            pipe.straggler.observe_tick(1.0, busy)
        if world.rank == spiker:
            for _ in range(pipe.straggler.patience):
                pipe.straggler.observe_tick(cfg.slow_factor, busy)
        out[spiker] = {
            "own_flags": pipe.straggler.persistent_stragglers(),
            "plan": _plan(pipe.mitigate_stragglers()),
            "n_data": pipe._n_data, "active": pipe.active}
    return out


def test_one_rank_wall_spike_gives_every_rank_one_decision():
    res = spawn_stream_mesh(N_RANKS, _decide_rank, backend="gloo",
                            device="cpu", timeout=TIMEOUT)
    # the first rank holds no flag: nobody reshards, the spiker included
    late = [r[2] for r in res]
    assert [r["own_flags"] for r in late] == [[], [], [SLOW], []]
    assert all(r["plan"] is None and r["n_data"] == 4 and r["active"]
               for r in late)
    # the first rank's own flag: every rank reshards 4 -> 2 together
    first = [r[0] for r in res]
    assert [r["own_flags"] for r in first] == [[SLOW], [], [], []]
    plans = [r["plan"] for r in first]
    assert plans[0] is not None and plans[0][:2] == (4, 2)
    assert all(p == plans[0] for p in plans)
    # the slow shard and one more go: ranks 0 and 2 keep the parts
    assert [r["active"] for r in first] == [True, False, True, False]
