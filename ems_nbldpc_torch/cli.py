"""Command-line front end of the PyTorch port.

Port of ``ems_nbldpc_tpu/cli.py``, with its flags and defaults and one
flag more, ``--device`` (default ``cuda``: the simulator runs on the card
unless the caller asks for the CPU).  Two call styles:

1. **Reference-compatible positional form** (the 7-argument contract of
   the reference's ``NB_LDPC.c:105-111``)::

       python -m ems_nbldpc_torch.cli NbMonteCarlo NbIterMax FileMatrix \\
           EbN NbMax Offset NbOper [flags...]

   ``NbOper`` bounds the elementary-step candidate budget on the
   truncated-list EMS path (``--storage compressed``); the dense paths
   examine all nm*q candidates and ignore it.

2. **Flag form**::

       python -m ems_nbldpc_torch.cli --matrix KN/N576_K480_GF64.txt \\
           --ebn0 3.0:5.0:0.5 --iters 10 --nm 30 --offset 0.3 \\
           --schedule layered --batch 4096 --stop-errors 40

``--devices N`` shards the frames of each batch over N devices of the
``--device`` kind (``parallel/mesh``; ``--batch`` is then per device):
N = 1 runs in this process as a world of 1; N > 1 starts N ranks
(``spawn``), one per card or, with ``--device cpu``, per CPU process,
unless the command runs under ``torchrun``, whose ranks it joins.  A rank
that fails makes the command fail.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def _parse_grid(spec: str):
    if ":" in spec:
        parts = [float(x) for x in spec.split(":")]
        lo, hi = parts[0], parts[1]
        step = parts[2] if len(parts) > 2 else 0.5
        return list(np.round(np.arange(lo, hi + 1e-9, step), 6))
    return [float(x) for x in spec.split(",")]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="ems_nbldpc_torch",
        description="NB-LDPC EMS Monte-Carlo simulator (PyTorch + CUDA)",
    )
    p.add_argument("positional", nargs="*", help="reference-style args: "
                   "NbMonteCarlo NbIterMax FileMatrix EbN NbMax Offset NbOper")
    p.add_argument("--matrix", help="matrix name or path")
    p.add_argument("--format", default="auto",
                   choices=["auto", "kn", "ubs", "alist"])
    p.add_argument("--ebn0", help="Eb/N0 grid: lo:hi:step or comma list")
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--nm", type=int, default=0, help="message truncation")
    p.add_argument("--offset", type=float, default=0.3)
    p.add_argument("--nboper", type=int, default=0,
                   help="elementary-step candidate budget (reference arg 7);"
                        " 0 = exact top-nm merge; honored by the compressed"
                        " truncated-list EMS path and by --cn-impl bubble /"
                        " lbubble (0 = 2 nm there)")
    p.add_argument("--schedule", default="layered",
                   choices=["layered", "flooding"])
    p.add_argument("--cn", default="ems",
                   choices=["ems", "minsum", "spa", "syndrome"])
    p.add_argument("--cn-impl", default="auto",
                   choices=["auto", "dense", "topk", "pallas", "bubble",
                            "lbubble"],
                   help="elementary-combine backend (pallas: the "
                        "hand-written CUDA check node; bubble/lbubble: the "
                        "exact 8-bubble / L-bubble emulation of the C "
                        "reference, with the --nboper budget)")
    p.add_argument("--batch", type=int, default=2048, help="frames/batch")
    p.add_argument("--max-frames", type=int, default=10_000_000)
    p.add_argument("--stop-errors", type=int, default=40,
                   help="stop after this many erroneous frames "
                        "(reference NB_LDPC.c:506)")
    p.add_argument("--channel", default="bpsk",
                   choices=["bpsk", "qam", "apsk64", "qam256_4d"])
    p.add_argument("--rayleigh", action="store_true")
    p.add_argument("--ssd", action="store_true")
    p.add_argument("--rotated", action="store_true")
    p.add_argument("--erasure", type=float, default=0.0)
    p.add_argument("--encode", default="device", choices=["device", "zero"])
    p.add_argument("--storage", default="dense",
                   choices=["dense", "compressed"])
    p.add_argument("--loop", default="device",
                   choices=["device", "host"])
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--seed", type=int, default=5)
    p.add_argument("--devices", type=int, default=0,
                   help="shard frames over this many devices of the "
                        "--device kind (0 = no mesh; --batch is per device)")
    p.add_argument("--device", default="cuda",
                   help="torch device the simulation runs on (cuda, cpu)")
    p.add_argument("--out", default="./data", help="result directory")
    p.add_argument("--resume", action="store_true",
                   help="skip Eb/N0 points already recorded in "
                        "<out>/results.jsonl for this exact config "
                        "(checkpoint/resume for interrupted sweeps)")
    p.add_argument("--quiet", action="store_true")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    # reference positional form
    if args.positional:
        if len(args.positional) < 7:
            print("need 7 positional args: NbMonteCarlo NbIterMax FileMatrix "
                  "EbN NbMax Offset NbOper", file=sys.stderr)
            return 2
        nmc, nit, matrix, ebn, nm, off, nboper = args.positional[:7]
        args.max_frames = int(nmc)
        args.iters = int(nit)
        args.matrix = matrix
        args.ebn0 = ebn
        args.nm = int(nm)
        args.offset = float(off)
        args.nboper = int(nboper)
    if not args.matrix or not args.ebn0:
        print("--matrix and --ebn0 are required", file=sys.stderr)
        return 2
    if args.devices > 1:
        import torch.distributed as dist

        from .parallel.mesh import launch

        if not dist.is_initialized() and "WORLD_SIZE" not in os.environ:
            launch(args.devices, main,
                   (sys.argv[1:] if argv is None else list(argv),),
                   devices=args.device)
            return 0

    from .decoder.api import DecoderConfig
    from .models.channels import ChannelSpec
    from .models.code import load
    from .models.registry import matrix_path
    from .sim.mc import SimConfig
    from .sim.sweep import run_sweep

    code = load(matrix_path(args.matrix), fmt=args.format, name=args.matrix)
    spec = ChannelSpec(
        kind=args.channel,
        rotated=args.rotated, rayleigh=args.rayleigh, ssd=args.ssd,
        erasure_prob=args.erasure,
        sigma_convention="ebn0" if args.channel == "bpsk" else "snr",
    )
    base = SimConfig(
        ebn0_db=0.0, frames_per_batch=args.batch, max_frames=args.max_frames,
        stop_errors=args.stop_errors, seed=args.seed, channel=spec,
        decoder=DecoderConfig(
            max_iters=args.iters, schedule=args.schedule, cn=args.cn,
            nm=args.nm, offset=args.offset, nboper=args.nboper,
            cn_impl=args.cn_impl,
            storage=args.storage, loop=args.loop, dtype=args.dtype,
        ),
        encode=args.encode,
    )
    mesh = None
    if args.devices:
        from .parallel.mesh import make_mesh

        mesh = make_mesh(args.devices, devices=args.device)
    try:
        run_sweep(code, _parse_grid(args.ebn0), base, out_dir=args.out,
                  verbose=not args.quiet, mesh=mesh, resume=args.resume,
                  device=args.device)
    finally:
        if mesh is not None:
            mesh.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
