"""The mesh phases' ranks: processes spawned on this one card over gloo
(NCCL refuses two ranks on one device). gloo meets them at barriers, and a
collective's data moves through staging buffers on the card that every
rank maps (CUDA IPC, ``parallel/distributed.py``). The mesh's math and its
kernel launches are checked; its times are one card's, not multi-GPU
times. Each rank writes what it found into ``MESH_DIR``. One spawn of ranks
runs several jobs in turn (``mesh_jobs``): its ranks' start (the
interpreter, torch, the card, the process group) costs more than a reduced
mesh's whole denoise.
"""
from __future__ import annotations

import gc
import json
import os
import re
import time

from .common import MESH_DIR, say


# the running job's prefix of its files in MESH_DIR (``_jobs_rank``)
MESH_TAG = ""


def mesh_path(name: str, tag=None) -> str:
    """The file ``name`` of job ``tag`` in MESH_DIR (this rank's running
    job's when None)."""
    return os.path.join(MESH_DIR, (MESH_TAG if tag is None else tag) + name)


def _jobs_rank(rank, jobs):
    """Each ``(tag, fn, args)`` of ``jobs`` in turn on this rank,
    ``fn(rank, *args)`` writing its files under ``tag``; between two jobs
    their card memory and the shared staging buffers are given back."""
    global MESH_TAG
    import torch
    from fantasy_world_tpu_torch.parallel import distributed
    for tag, fn, args in jobs:
        MESH_TAG = tag
        t0 = time.perf_counter()
        fn(rank, *args)
        gc.collect()
        distributed.release_shared()
        torch.cuda.empty_cache()
        if rank == 0:
            say("mesh_job", job=tag.rstrip("_"),
                seconds=f"{time.perf_counter() - t0:.2f}")
    MESH_TAG = ""


# the files a job writes under its tag (``mesh_path``)
JOB_FILES = re.compile(r"(rank\d+\.json|outputs\.pt|refs\.pt|train\.pt|"
                       r"train_grads\.pt|pipe\d+\.pt)")
# the open worlds of this process, by size (``world``)
WORLDS = {}


def _serve_jobs(rank, inboxes, done):
    """A rank of a ``World``: each job list put in its inbox in turn
    (``_jobs_rank``), one word to ``done`` after each, until None."""
    while True:
        jobs = inboxes[rank].get()
        if jobs is None:
            return
        _jobs_rank(rank, jobs)
        done.put(rank)


class World:
    """``size`` ranks spawned once on this card over gloo, each a process
    of its own, that run the job lists given to them (``run``, ``submit``)
    in turn until ``close``: one start of the ranks (the interpreter,
    torch, the card, the process group) for every job list, and job lists
    of other worlds beside them."""

    def __init__(self, size):
        import multiprocessing
        import threading
        from concurrent.futures import ThreadPoolExecutor

        import torch.multiprocessing as tmp
        from fantasy_world_tpu_torch.parallel import distributed
        ctx = multiprocessing.get_context("spawn")
        self.size, self.error = size, None
        self.inboxes = [ctx.SimpleQueue() for _ in range(size)]
        self.done = ctx.Queue()
        # the local launcher's rank body (``distributed.spawn``), started
        # without waiting for the ranks to end
        self.ranks = tmp.start_processes(
            distributed._rank_main,
            args=(_serve_jobs, size, distributed.free_port(), "gloo", "cuda",
                  600.0, (self.inboxes, self.done)),
            nprocs=size, join=False, start_method="spawn")
        self.watcher = threading.Thread(target=self._watch, daemon=True)
        self.watcher.start()
        self.lock = threading.Lock()
        self.queue = ThreadPoolExecutor(1)

    def _watch(self):
        try:
            while not self.ranks.join(timeout=1.0):
                pass
        except BaseException as e:  # noqa: BLE001 -- raised by ``run``
            self.error = e

    def run(self, jobs):
        """``jobs`` [(tag, fn, args)] one after another on every rank;
        then {tag: each rank's JSON record}. Raises if a rank failed."""
        import queue
        os.makedirs(MESH_DIR, exist_ok=True)
        tags = {tag for tag, _, _ in jobs}
        for name in os.listdir(MESH_DIR):
            if any(name.startswith(t) and JOB_FILES.fullmatch(name[len(t):])
                   for t in tags):
                os.remove(os.path.join(MESH_DIR, name))
        with self.lock:
            for inbox in self.inboxes:
                inbox.put(jobs)
            finished = 0
            while finished < self.size:
                try:
                    self.done.get(timeout=1.0)
                    finished += 1
                except queue.Empty:
                    if not self.watcher.is_alive():
                        raise RuntimeError(f"a rank of the {self.size}-rank "
                                           f"world failed: {self.error}")
        records = {}
        for tag, _, _ in jobs:
            records[tag] = []
            for r in range(self.size):
                with open(mesh_path(f"rank{r}.json", tag)) as fh:
                    records[tag].append(json.load(fh))
        return records

    def submit(self, jobs, after=None):
        """``run(jobs)`` in the background, after the job lists submitted
        before and after the future ``after`` (its failure raised);
        returns the future of (the records, the run's wall seconds)."""
        def task():
            if after is not None:
                after.result()
            t0 = time.perf_counter()
            records = self.run(jobs)
            return records, time.perf_counter() - t0
        return self.queue.submit(task)

    def close(self, abort=False):
        """The ranks stopped: at once with ``abort``, else after their
        job lists."""
        if abort:
            for proc in self.ranks.processes:
                if proc.is_alive():
                    proc.terminate()
        else:
            self.queue.shutdown(wait=True)
            for inbox in self.inboxes:
                inbox.put(None)
        self.watcher.join()
        self.queue.shutdown(wait=not abort, cancel_futures=abort)
        if self.error is not None and not abort:
            raise RuntimeError(f"a rank of the {self.size}-rank world "
                               f"failed: {self.error}")


def world(size):
    """This process's open world of ``size`` ranks, started if none is."""
    if size not in WORLDS:
        WORLDS[size] = World(size)
    return WORLDS[size]


def close_worlds(*sizes, abort=False):
    """Close the open worlds of ``sizes`` (all when none is named)."""
    for size in sizes or list(WORLDS):
        if size in WORLDS:
            WORLDS.pop(size).close(abort)


def mesh_jobs(size, jobs):
    """``jobs`` [(tag, fn, args)] one after another on ``size`` ranks on
    this card (``_jobs_rank``): the open world of that size, else one
    spawned for them and closed after; then {tag: each rank's JSON
    record}."""
    if size in WORLDS:
        return WORLDS[size].run(jobs)
    ranks = World(size)
    try:
        records = ranks.run(jobs)
    except BaseException:
        ranks.close(abort=True)
        raise
    ranks.close()
    return records


def mesh_run(fn, size, *args):
    """``fn(rank, *args)`` on ``size`` ranks on this card (``mesh_jobs``);
    then each rank's JSON record (``MESH_DIR/rank{r}.json``)."""
    return mesh_jobs(size, [("", fn, args)])[""]


def rank_setup():
    """A rank's start of a job: the kernels the parent built loaded, TF32
    off; returns its device."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from fantasy_world_tpu_torch.ops import flash_attention as fa
    fa.build_kernels()          # loads what the parent built
    return torch.device("cuda", torch.cuda.current_device())


def rank_record(rank, **fields):
    """This rank's JSON record of the running job."""
    with open(mesh_path(f"rank{rank}.json"), "w") as fh:
        json.dump(fields, fh)


def gloo_cuda_probe():
    """Which gloo collectives take CUDA tensors in this torch (the mesh
    layer does not use them on CUDA tensors whatever the answer: ranks that
    share the card meet in CUDA IPC staging buffers): {op: "ok" or the
    error's first line}."""
    import torch
    import torch.distributed as dist
    n = dist.get_world_size()
    x = torch.ones(4, device="cuda", dtype=torch.bfloat16)
    ops = {
        "all_reduce": lambda: dist.all_reduce(x.clone()),
        "all_gather": lambda: dist.all_gather(
            [torch.empty_like(x) for _ in range(n)], x),
        "broadcast": lambda: dist.broadcast(x.clone(), 0),
        "all_to_all_single": lambda: dist.all_to_all_single(
            torch.empty(2 * n, device="cuda"), torch.ones(2 * n,
                                                          device="cuda")),
    }
    out = {}
    for name, op in ops.items():
        try:
            op()
            torch.cuda.synchronize()
            out[name] = "ok"
        except Exception as e:  # noqa: BLE001 -- reported, not relied on
            out[name] = str(e).splitlines()[0][:80]
        dist.barrier()
    return out


def mesh_tag(shape) -> str:
    """A mesh shape's part of a job tag: "1x2x1_"."""
    return "x".join(map(str, shape)) + "_"
