"""Run a function on N ranks of one machine: N spawned processes joined in
one ``torch.distributed`` process group through a ``file://`` store (no
port to pick, none to collide). The tests run the port's collectives on the
CPU this way over gloo, and ``chip_smoke.py`` runs ranks that share one card.
``torchrun`` launches the CLIs; this is for functions.
"""

from __future__ import annotations

import multiprocessing
import os
import queue as queue_mod
import traceback
from typing import Any, Callable, List, Sequence


def _entry(fn_path, rank: int, world: int, store: str, device: str, args,
           results):
    import importlib

    import torch.distributed as dist

    from imagetranslate_tpu_torch.parallel.mesh import init_distributed

    try:
        module, name = fn_path
        fn = getattr(importlib.import_module(module), name)
        # One machine: the local rank is the rank (torchrun's variables), so
        # that each rank takes a card of its own where there are enough.
        os.environ["LOCAL_RANK"] = str(rank)
        os.environ["LOCAL_WORLD_SIZE"] = str(world)
        init_distributed(store, world, rank, device)
        out = fn(rank, *args)
        results.put((rank, True, out))
    except BaseException:      # SystemExit too: the parent must hear of it
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn: Callable, world: int, store_file: str,
              args: Sequence[Any] = (), device: str = "cpu",
              timeout: float = 600.0) -> List[Any]:
    """[fn(0, *args), ..., fn(world - 1, *args)], each run in a process of
    its own after ``init_distributed`` over ``store_file`` (a path that does
    not exist yet). ``fn`` must be a module-level function: it travels by
    name and each process imports it once torch is loaded (importing it
    while the spawned process unpickles its arguments measured twice as
    slow). Its result must be picklable. Raises with the first failing rank's traceback,
    or if a rank gives no answer within ``timeout`` seconds."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_entry,
                         args=((fn.__module__, fn.__qualname__), r, world,
                               "file://" + store_file, device, tuple(args),
                               results))
             for r in range(world)]
    for p in procs:
        p.start()
    got = {}
    try:
        for _ in range(world):
            rank, ok, out = results.get(timeout=timeout)
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{out}")
            got[rank] = out
    except queue_mod.Empty:
        raise RuntimeError(f"{world - len(got)} of {world} ranks gave no "
                           f"answer in {timeout} s") from None
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
    return [got[r] for r in range(world)]
