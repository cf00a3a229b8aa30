"""A cell on several cards: one rank a card, started by the program's own
``parallel.mesh.launch`` (NCCL between cards, gloo between CPU processes;
the rendezvous in a temporary directory under TMPDIR), each rank driving
``parallel.mesh.sharded_batch_step`` on F frames of its own.

Rank 0's clock sets the window's length: after the window's first few
batches it turns ``seconds`` into a number of batches from their rate and
broadcasts it once, on a gloo group of the harness's own, so all ranks run
the same batches and no host collective of the harness's follows any other
batch.  Each rank writes its record (``cellrun.run_rank``) to
the temporary directory, and the parent reads them once the ranks have
ended.
"""
from __future__ import annotations

import os
import pickle
import tempfile
import time


def _rank(cell: dict, seed: int, seconds: float, trace: bool, devices: str,
          t0_epoch: float, out_dir: str) -> None:
    import torch
    import torch.distributed as dist

    from ems_nbldpc_torch.parallel.mesh import make_mesh
    from simbench.cellrun import run_rank

    mesh = make_mesh(dist.get_world_size(), devices)
    group = dist.new_group(backend="gloo")
    total = torch.zeros(1, dtype=torch.int64)

    def agree(done: int, elapsed: float) -> int:
        if mesh.rank == 0:
            total[0] = max(done, round(done * seconds / elapsed))
        dist.broadcast(total, src=0, group=group)
        return int(total[0])

    rec = run_rank(cell, seed, seconds, trace, str(mesh.device), t0_epoch,
                   mesh=mesh, agree=agree, clock=time.time,
                   barrier=lambda: dist.barrier(group=group))
    path = os.path.join(out_dir, f"rank{mesh.rank}.pkl")
    with open(path + ".tmp", "wb") as f:
        pickle.dump(rec, f)
    os.replace(path + ".tmp", path)


def run_ranks(cell: dict, seed: int, seconds: float, trace: bool,
              devices: str, t0_epoch: float, join_timeout: float = 330.0,
              rank_fn=None) -> list:
    """The records of the cell's ranks, rank 0 first.  ``rank_fn``: a
    module-level function that stands in for a rank's run (its tests)."""
    from ems_nbldpc_torch.parallel.mesh import launch

    ranks = cell["chips"]
    with tempfile.TemporaryDirectory() as out_dir:
        launch(ranks, rank_fn or _rank, args=(cell, seed, seconds, trace, devices,
                                   t0_epoch, out_dir),
               devices=devices, join_timeout=join_timeout)
        recs = []
        for r in range(ranks):
            with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
                recs.append(pickle.load(f))
    return recs
