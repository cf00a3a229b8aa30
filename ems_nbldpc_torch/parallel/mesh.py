"""Multi-GPU Monte-Carlo: frames sharded over processes, one per device.

Port of ``ems_nbldpc_tpu/parallel/mesh.py``.  The reference scales out by
forking one OS process per SNR point (its ``start.sh:18-22``) with no
inter-process communication.  Here, as in JAX, the frames of a
batch are sharded: frames are i.i.d., so each rank decodes its own
``frames_per_batch`` frames from its own random streams, and only the six
integer counters cross ranks, all-reduced with ``torch.distributed``.

One process per device: NCCL between cards, gloo between CPU processes,
chosen from the device kind the caller names and never swapped for the
other.  ``launch`` starts the ranks of one host (``spawn``, a file
rendezvous in a temporary directory); under ``torchrun`` (``RANK`` and
``WORLD_SIZE`` set) ``make_mesh`` joins the launcher's group instead, so
a mesh may span hosts, which ``make_mesh_2d`` lays out as (hosts, chips).
The rendezvous and every collective time out after ``TIMEOUT_S``, so a
dead rank fails its peers instead of hanging them.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import tempfile
import time
import warnings
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..models.code import NBCode
from ..sim.mc import MonteCarlo, SimConfig, SimResult
from ..utils.timing import span

TIMEOUT_S = 600.0     # seconds for the rendezvous and for each collective


@dataclasses.dataclass
class Mesh:
    """This rank's view of a frame-sharding mesh."""
    world: int                 # ranks (devices) in the mesh
    rank: int
    device: torch.device       # cuda:<local rank>, or cpu
    group: Any                 # the process group of the whole mesh
    shape: tuple               # (world,), or (hosts, chips) for 2-D
    ici: Any = None            # 2-D: the ranks of this rank's host
    dcn: Any = None            # 2-D: this local index across the hosts
    owned: bool = False        # make_mesh initialised the process group

    def close(self) -> None:
        """Destroy the process group if ``make_mesh`` created it."""
        if self.owned and dist.is_initialized():
            dist.destroy_process_group()


def _kind(devices) -> str:
    kind = torch.device(devices or "cuda").type
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"devices={devices!r}: expected 'cuda' or 'cpu'")
    return kind


def backend_for(devices) -> str:
    """NCCL between cards, gloo between CPU processes."""
    return "nccl" if _kind(devices) == "cuda" else "gloo"


def check_visible(n_devices: int, devices="cuda") -> None:
    """Raise ``ValueError`` if this host shows fewer than ``n_devices``
    devices of the kind: CUDA cards, or CPU cores (one process each)."""
    kind = _kind(devices)
    count = torch.cuda.device_count() if kind == "cuda" else os.cpu_count()
    if count < n_devices:
        raise ValueError(
            f"requested a {n_devices}-device mesh but only {count} {kind} "
            "device(s) are visible (one process per device: a card each, "
            "or on the CPU a core each; start them with "
            "parallel.mesh.launch or torchrun)")


def _timeout(timeout: float) -> datetime.timedelta:
    return datetime.timedelta(seconds=timeout)


def make_mesh(n_devices: Optional[int] = None, devices="cuda",
              timeout: float = TIMEOUT_S) -> Mesh:
    """1-D frame-sharding mesh of the initialised process group, on
    ``devices`` ("cuda", the default, or "cpu").

    With no group yet: under ``torchrun`` it joins the launcher's group
    (``env://``); otherwise it makes a world of 1 in this process, and a
    larger ``n_devices`` is an error (``launch`` starts the ranks).
    ``n_devices`` (default: the world) must equal the world size."""
    kind = _kind(devices)
    owned = False
    if not dist.is_initialized():
        env = os.environ
        if "RANK" in env and "WORLD_SIZE" in env:
            world = int(env["WORLD_SIZE"])
            check_visible(int(env.get("LOCAL_WORLD_SIZE", world)), kind)
            dist.init_process_group(backend_for(kind), init_method="env://",
                                    timeout=_timeout(timeout))
        else:
            check_visible(n_devices or 1, kind)
            if (n_devices or 1) != 1:
                raise ValueError(
                    f"a {n_devices}-device mesh needs {n_devices} processes: "
                    "start them with parallel.mesh.launch or torchrun")
            dist.init_process_group(backend_for(kind), store=dist.HashStore(),
                                    rank=0, world_size=1,
                                    timeout=_timeout(timeout))
        owned = True
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"requested a {n_devices}-device mesh in a world of "
                         f"{world} processes")
    backend = dist.get_backend()
    if backend != backend_for(kind):
        raise ValueError(f"the process group runs {backend}; a {kind} mesh "
                         f"needs {backend_for(kind)}")
    if kind == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
    return Mesh(world=world, rank=rank, device=device, group=dist.group.WORLD,
                shape=(world,), owned=owned)


def make_mesh_2d(hosts: int, chips_per_host: int, devices="cuda",
                 timeout: float = TIMEOUT_S) -> Mesh:
    """(hosts, chips) mesh for multi-host runs: rank r sits on host
    ``r // chips_per_host`` at local index ``r % chips_per_host``.

    Frames shard over both axes.  The counters reduce over ``ici`` (the
    ranks of one host) and then over ``dcn`` (one rank per host), so only
    the last, host-count-sized reduction crosses hosts."""
    mesh = make_mesh(hosts * chips_per_host, devices, timeout)
    host, chip = divmod(mesh.rank, chips_per_host)
    ici = dcn = None
    for h in range(hosts):           # every rank makes every group
        g = dist.new_group([h * chips_per_host + c
                            for c in range(chips_per_host)],
                           timeout=_timeout(timeout))
        ici = g if h == host else ici
    for c in range(chips_per_host):
        g = dist.new_group([h * chips_per_host + c for h in range(hosts)],
                           timeout=_timeout(timeout))
        dcn = g if c == chip else dcn
    return dataclasses.replace(mesh, shape=(hosts, chips_per_host), ici=ici,
                               dcn=dcn)


def _shardable(cfg: SimConfig) -> SimConfig:
    """Rewrite a decoder config into the one a sharded run decodes, as
    JAX's sharded run does.

    ``loop="host"`` becomes ``"device"``, and the compressed dense-CN
    decoder (``storage="compressed"`` with ``cn_impl="topk"``) the
    truncated-list EMS decoder (``cn_impl="auto"``): JAX cannot put host
    control flow under ``shard_map``, so its sharded run decodes these,
    and so does the port's.  The rewrite is announced with a
    ``UserWarning``: the replacement paths are argued-equivalent but not
    bit-identical (the compressed dense-CN decoder computes f32 top-k
    where the list CN uses bf16 packed-key sorts).
    """
    d = cfg.decoder
    repl = {}
    if d.loop == "host":
        repl["loop"] = "device"
    if d.storage == "compressed" and d.cn_impl == "topk":
        repl["cn_impl"] = "auto"   # list path: the shardable compressed CN
    if repl:
        warnings.warn(
            f"sharded execution rewrote decoder config {repl} (host control "
            "flow cannot live under shard_map); semantics are equivalent "
            "but numerics may differ slightly from the unsharded run",
            stacklevel=3,
        )
        cfg = dataclasses.replace(cfg, decoder=dataclasses.replace(d, **repl))
    return cfg


def _all_reduce(counters: torch.Tensor, groups) -> torch.Tensor:
    """The first five counters summed, the decoder steps (the sixth) the
    largest, over each group in turn; in the span ``nbldpc.allreduce``."""
    with span("allreduce"):
        head, steps = counters[:5].clone(), counters[5:].clone()
        for g in groups:
            dist.all_reduce(head, op=dist.ReduceOp.SUM, group=g)
            dist.all_reduce(steps, op=dist.ReduceOp.MAX, group=g)
        return torch.cat([head, steps])


def _sharded_step(code: NBCode, cfg: SimConfig, mesh: Mesh, groups):
    cfg = _shardable(cfg)
    mc = MonteCarlo(code, cfg, device=mesh.device, shard=mesh.rank)

    def run_step(batch_idx: int, ebn0=None) -> torch.Tensor:
        ebn0 = cfg.ebn0_db if ebn0 is None else float(ebn0)
        if mc.cfg.ebn0_db != ebn0:
            mc.cfg = dataclasses.replace(cfg, ebn0_db=ebn0)
        counters, _ = mc.step(batch_idx)
        return _all_reduce(counters, groups)

    return run_step


def sharded_batch_step(code: NBCode, cfg: SimConfig, mesh: Mesh):
    """Build ``run_step(batch_idx, ebn0=None)`` -> the global counters [6]
    (``MonteCarlo.count``'s; on every rank, on its device).

    ``cfg.frames_per_batch`` is the *per-device* batch.  Each rank runs
    ``MonteCarlo.step`` on its own streams (``shard=rank``): its decodes
    share one device-loop key, so one capture per rank serves every batch
    and every Eb/N0 point (Eb/N0 enters the channel only)."""
    return _sharded_step(code, cfg, mesh, [mesh.group])


def sharded_batch_step_2d(code: NBCode, cfg: SimConfig, mesh: Mesh):
    """``sharded_batch_step`` on a ``make_mesh_2d`` mesh: the counters
    reduce over ``ici`` and then over ``dcn``."""
    return _sharded_step(code, cfg, mesh, [mesh.ici, mesh.dcn])


def run_sharded(code: NBCode, cfg: SimConfig, mesh: Mesh,
                verbose: bool = False, step=None) -> SimResult:
    """Monte-Carlo loop over the mesh; mirrors ``MonteCarlo.run``.  Every
    rank holds the same totals, so every rank stops on the same batch;
    only rank 0 prints.

    Pass a prebuilt ``step`` (from ``sharded_batch_step``) to reuse one
    device loop across the SNR points of a sweep."""
    if step is None:
        step = sharded_batch_step(code, cfg, mesh)
    verbose = verbose and mesh.rank == 0
    totals = np.zeros(6, dtype=np.int64)
    t0 = time.perf_counter()
    b = 0
    while totals[0] < cfg.max_frames and totals[1] < cfg.stop_errors:
        totals += step(b, cfg.ebn0_db).cpu().numpy()
        b += 1
        if verbose:
            print(f"\rFER={totals[1]}/{totals[0]}", end="", flush=True)
    elapsed = time.perf_counter() - t0
    if verbose:
        print()
    return SimResult(
        frames=int(totals[0]), frame_errors=int(totals[1]),
        bit_errors=int(totals[2]), undetected_errors=int(totals[3]),
        iter_sum=int(totals[4]), elapsed_s=elapsed, config=cfg,
        code_name=code.name, n=code.n, k=code.k, logq=code.logq,
        decoder_steps=int(totals[5]),
    )


def _rank_main(rank: int, world: int, init_method: str, kind: str,
               timeout: float, fn, args) -> None:
    if kind == "cuda":
        torch.cuda.set_device(rank)
    elif "OMP_NUM_THREADS" not in os.environ:      # share the cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    dist.init_process_group(backend_for(kind), init_method=init_method,
                            world_size=world, rank=rank,
                            timeout=_timeout(timeout))
    try:
        fn(*args)
    finally:
        dist.destroy_process_group()


def launch(nprocs: int, fn, args=(), *, devices="cuda",
           timeout: float = TIMEOUT_S,
           join_timeout: Optional[float] = None) -> None:
    """Run ``fn(*args)`` in ``nprocs`` new processes (``spawn``), rank r on
    ``cuda:r`` or on the CPU, each in the initialised process group of the
    world (``make_mesh`` there returns its mesh).  ``fn`` must be a
    module-level function.  Raises if a rank fails (and stops the others),
    or, given ``join_timeout``, if the ranks are not done within it."""
    import torch.multiprocessing as mp

    kind = _kind(devices)
    check_visible(nprocs, kind)
    with tempfile.TemporaryDirectory() as tmp:
        init_method = "file://" + os.path.join(tmp, "rendezvous")
        ctx = mp.start_processes(
            _rank_main, args=(nprocs, init_method, kind, timeout, fn, args),
            nprocs=nprocs, join=False, start_method="spawn")
        deadline = (None if join_timeout is None
                    else time.monotonic() + join_timeout)
        while not ctx.join(timeout=1.0):
            if deadline is not None and time.monotonic() > deadline:
                for p in ctx.processes:
                    if p.is_alive():
                        p.kill()
                raise TimeoutError(f"{nprocs} ranks not done within "
                                   f"{join_timeout} s")
