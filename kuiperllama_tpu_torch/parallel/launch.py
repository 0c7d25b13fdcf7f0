"""Run SPMD functions on a group of local ranks: `world` spawned processes
(torch.multiprocessing, spawn start) joined in one torch.distributed group.

    with RankPool(2, backend="gloo", init_method="file:///tmp/rdv") as pool:
        out = pool.run(fn, arg)     # fn(arg) on every rank; out[r] is rank r's

`fn` must be importable by name in a fresh interpreter (a module-level
function) and return a picklable value (numpy arrays, lists: not CUDA
tensors). Every rank runs the same calls in the same order, as SPMD code
expects; a call that raises on any rank raises here with each failing
rank's traceback. The group's timeout bounds every collective, so a rank
that hangs fails its peers instead of blocking them, and `run` gives up
after `timeout_s` plus a margin. `close` (or leaving the `with`) stops
every process the pool started.
"""

from __future__ import annotations

import queue
import traceback

import torch
import torch.multiprocessing as mp

from .mesh import initialize_distributed

# how long the ranks may take to spawn and import, each
_START_S = 120.0


def _serve(rank, world, backend, init_method, timeout_s, device, threads, tasks,
           results, started):
    import torch.distributed as dist

    try:
        torch.set_num_threads(threads)
        if device is not None and torch.device(device).type == "cuda":
            torch.cuda.set_device(torch.device(device))
        # every rank has started before any joins the group: the group's
        # timeout (its rendezvous too) then bounds the ranks' skew, not
        # how long each took to spawn
        started.wait(_START_S)
        initialize_distributed(init_method, world, rank, backend=backend,
                               timeout_s=timeout_s)
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        return
    results.put((rank, True, "ready"))
    try:
        while True:
            item = tasks.get()
            if item is None:
                break
            fn, args = item
            try:
                results.put((rank, True, fn(*args)))
            except BaseException:
                results.put((rank, False, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


class RankPool:
    """`world` ranks in spawned processes, joined in one process group of
    `backend` ("gloo" or "nccl": the caller's choice) through `init_method`
    (such as "file:///path/rendezvous" or "tcp://127.0.0.1:port"). device:
    the CUDA device every rank sets as its current one (None: none set).
    threads: torch's intra-op threads per rank."""

    def __init__(self, world: int, backend: str, init_method: str,
                 timeout_s: float = 120.0, device=None, threads: int = 1):
        ctx = mp.get_context("spawn")
        self.world, self.timeout_s = world, timeout_s
        self._tasks = [ctx.Queue() for _ in range(world)]
        self._results = ctx.Queue()
        started = ctx.Barrier(world)
        self.procs = [ctx.Process(target=_serve, daemon=True,
                                  args=(r, world, backend, init_method, timeout_s,
                                        device, threads, self._tasks[r],
                                        self._results, started))
                      for r in range(world)]
        for p in self.procs:
            p.start()
        try:
            self._collect("joining the group", _START_S + timeout_s)
        except BaseException:
            self.close()
            raise

    def _collect(self, what: str, wait_s: float) -> list:
        out, errors = {}, {}
        while len(out) + len(errors) < self.world:
            try:
                rank, ok, value = self._results.get(timeout=wait_s)
            except queue.Empty:
                dead = [r for r, p in enumerate(self.procs) if not p.is_alive()]
                raise RuntimeError(f"RankPool: no answer from every rank while "
                                   f"{what} (ranks {sorted(out)} answered; "
                                   f"exited: {dead})") from None
            (out if ok else errors)[rank] = value
        if errors:
            raise RuntimeError(f"RankPool: {len(errors)} rank(s) failed while "
                               f"{what}:\n" + "\n".join(
                                   f"--- rank {r} ---\n{tb}"
                                   for r, tb in sorted(errors.items())))
        return [out[r] for r in range(self.world)]

    def run(self, fn, *args) -> list:
        """fn(*args) on every rank; the ranks' return values by rank."""
        for q in self._tasks:
            q.put((fn, args))
        return self._collect(f"running {getattr(fn, '__name__', fn)}",
                             self.timeout_s + 30)

    def close(self):
        for q, p in zip(self._tasks, self.procs):
            if p.is_alive():
                q.put(None)
        for p in self.procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
