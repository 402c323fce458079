"""Start R local ranks of a replica mesh: ``run_ranks`` spawns one process
per rank (``torch.multiprocessing``, the ``spawn`` start method), joins
them into one gloo process group through a ``file://`` rendezvous in a
fresh temporary directory, runs ``fn(rank, world_size, *args)`` in each
and returns the results in rank order.

This is how one host runs the mesh transport with several ranks: R
processes on the CPU (the tests) or R processes sharing one GPU. The
group is gloo in both cases (NCCL refuses two ranks on one device).
Build the CUDA kernels in the parent before the spawn
(``cuda_build.build_all``) so that the ranks load one build instead of
racing to make it.

A rank that raises, or any rank still running at the deadline, fails the
whole run: every rank is stopped and ``RuntimeError`` names the rank and
carries its traceback.
"""

from __future__ import annotations

import datetime
import os
import pickle
import tempfile
import time
import traceback
from pathlib import Path


def _rank_main(fn, rank, world_size, init, out_dir, timeout, args):
    import torch.distributed as dist

    out = Path(out_dir)
    try:
        dist.init_process_group(
            "gloo", init_method=init, rank=rank, world_size=world_size,
            timeout=datetime.timedelta(seconds=timeout))
        try:
            result = fn(rank, world_size, *args)
        finally:
            dist.destroy_process_group()
        tmp = out / f"rank{rank}.tmp"
        tmp.write_bytes(pickle.dumps(result))
        os.replace(tmp, out / f"rank{rank}.pkl")
    except BaseException:
        (out / f"rank{rank}.err").write_text(traceback.format_exc())
        raise


def run_ranks(fn, world_size: int, args=(), *,
              timeout: float = 600.0) -> list:
    """Run ``fn(rank, world_size, *args)`` on ``world_size`` spawned ranks
    of one gloo process group; return each rank's (picklable)
    result, in rank order. ``fn`` must be importable by the children (a
    module-level function). Raises ``RuntimeError`` when a rank fails or
    the ranks outlive ``timeout`` seconds."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="raft_ranks_") as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, world_size, init, tmp,
                                   timeout, tuple(args)), daemon=True)
                 for r in range(world_size)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        failed = None
        try:
            while failed is None and any(p.is_alive() for p in procs):
                for r, p in enumerate(procs):
                    if p.exitcode not in (None, 0):
                        failed = f"rank {r} exited with code {p.exitcode}"
                        break
                if failed is None and time.monotonic() > deadline:
                    failed = f"ranks still running after {timeout:g} s"
                time.sleep(0.02)
            for r, p in enumerate(procs):
                if failed is None and p.exitcode != 0:
                    failed = f"rank {r} exited with code {p.exitcode}"
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join(10)
                if p.is_alive():
                    p.kill()
                    p.join()
        if failed is not None:
            errs = sorted(Path(tmp).glob("rank*.err"))
            detail = "\n".join(f"--- {e.stem}:\n{e.read_text()}" for e in errs)
            raise RuntimeError(f"{failed}\n{detail}".rstrip())
        return [pickle.loads((Path(tmp) / f"rank{r}.pkl").read_bytes())
                for r in range(world_size)]
