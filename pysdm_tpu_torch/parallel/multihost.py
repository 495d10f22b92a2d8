"""Process groups and ranks (port of ``pysdm_tpu/parallel/multihost.py``).

The JAX package runs every shard in one process under ``shard_map`` and
spans hosts with ``jax.distributed``; PyTorch runs one process per rank.
Every rank calls :func:`initialize` first, with everything explicit: the
rendezvous (``init_method``, a ``file://`` path on one host, a
``tcp://host:port`` across hosts), the world size, its rank, the backend
and a timeout, so that a collective that never completes raises instead
of hanging. The backend is chosen before the group exists
(:func:`backend_for`): NCCL where every rank of a host has a GPU of its
own, gloo on the CPU or where ranks share one card (gloo carries CUDA
tensors through ``all_to_all``, ``all_reduce`` and ``all_gather`` by
staging them through the host).

Simulation state is built host-replicated (the same numpy arrays on every
rank, from the same seed); each rank keeps its own block
(:func:`host_replicated_to_local`), which its builder puts on its device.

:func:`spawn` runs a function in n fresh processes that form one group,
joined under a deadline: the CPU tests' ranks and the card's phase. The
processes come from a fork server: one process, started the way ``spawn``
starts one, imports the caller's main module and this package once and
forks every rank from there. It runs no thread and touches no device, so
its forks are as clean as spawned processes, and a rank starts in ~0.1 s
instead of the ~5 s that importing torch and the package takes. The fork
server, and the resource tracker that multiprocessing starts beside it,
outlive the spawn; :func:`shutdown` stops both and waits for them, and runs
at the exit of any process that spawned, so that no process outlives the
program that started it.
"""

import atexit
import datetime
import multiprocessing
import os
import queue
import shutil
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

# seconds; CPU tests share the cores with other test workers, so a
# spawn there may take several times its time alone
DEFAULT_TIMEOUT = 600.0


def backend_for(ranks_per_host, device_type):
    """``"nccl"`` where each of a host's ``ranks_per_host`` ranks has a GPU
    of its own, else ``"gloo"`` (the CPU, or ranks sharing cards)"""
    if device_type == "cuda" and torch.cuda.device_count() >= ranks_per_host:
        return "nccl"
    return "gloo"


def initialize(*, init_method, num_processes, process_id, backend,
               timeout=DEFAULT_TIMEOUT, local_rank=None):
    """``torch.distributed.init_process_group`` for this rank; with NCCL the
    rank's GPU (``local_rank``, default ``process_id``) becomes the current
    device first. ``timeout`` (seconds) bounds every collective."""
    if backend == "nccl":
        torch.cuda.set_device(process_id if local_rank is None else local_rank)
    dist.init_process_group(
        backend,
        init_method=init_method,
        world_size=num_processes,
        rank=process_id,
        timeout=datetime.timedelta(seconds=timeout),
    )


def host_replicated_to_local(tree, rank, n_ranks):
    """this rank's contiguous block, along the last axis, of every array in
    a dict of host-replicated numpy arrays (the same on every rank);
    0-d entries stay whole"""
    out = {}
    for key, value in tree.items():
        value = np.asarray(value)
        if value.ndim == 0:
            out[key] = value
            continue
        n = value.shape[-1] // n_ranks
        out[key] = value[..., rank * n:(rank + 1) * n]
    return out


def _rank_main(target, args, rank, n_ranks, backend, init_method, timeout,
               ranks_per_host, results):
    """a spawned rank: one thread, the group, ``target(*args)``; its result
    or its traceback goes to ``results``"""
    torch.set_num_threads(1)
    try:
        initialize(
            init_method=init_method, num_processes=n_ranks,
            process_id=rank, backend=backend, timeout=timeout,
            local_rank=rank % ranks_per_host,
        )
        try:
            results.put((rank, True, target(*args)))
        finally:
            dist.destroy_process_group()
    except BaseException:  # noqa: B036 - reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))
        raise


def shutdown():
    """stop the fork server that :func:`spawn` started and multiprocessing's
    resource tracker, waiting until both have exited (their ranks are
    joined already); a later spawn starts them anew. Does nothing where
    neither runs."""
    from multiprocessing import forkserver, resource_tracker

    # the server first: each rank it forked held the tracker's pipe
    forkserver._forkserver._stop()
    resource_tracker._resource_tracker._stop()


_shutdown_registered = False


def spawn(target, n_ranks, *args, backend="gloo", timeout=DEFAULT_TIMEOUT,
          ranks_per_host=None):
    """run ``target(*args)`` in ``n_ranks`` new processes that form one
    process group (a ``file://`` rendezvous in a fresh temporary
    directory); returns their results in rank order. ``target`` must be a
    module-level function (it is pickled by name), and so must what
    ``args`` hold. Raises RuntimeError with the rank's traceback when a
    rank fails or dies, TimeoutError when the ranks overrun ``timeout``
    seconds (every collective's limit too); every rank is stopped either
    way. ``ranks_per_host`` (default all) sets each rank's local rank.
    The fork server stays for the next spawn until :func:`shutdown`."""
    global _shutdown_registered
    ctx = multiprocessing.get_context("forkserver")
    if not _shutdown_registered:
        atexit.register(shutdown)
        _shutdown_registered = True
    # effective when the server starts, at this process's first spawn
    ctx.set_forkserver_preload(
        ["__main__", __name__, f"{__package__}.verification"]
    )
    results = ctx.Queue()
    workdir = tempfile.mkdtemp(prefix="pysdm_ranks_")
    init_method = "file://" + os.path.join(workdir, "rendezvous")
    procs = [
        ctx.Process(
            target=_rank_main,
            args=(target, args, rank, n_ranks, backend, init_method,
                  timeout, ranks_per_host or n_ranks, results),
            daemon=True,
        )
        for rank in range(n_ranks)
    ]
    try:
        for proc in procs:
            proc.start()
        return _collect(procs, results, time.monotonic() + timeout)
    finally:
        started = [proc for proc in procs if proc.pid is not None]
        for proc in started:
            if proc.is_alive():
                proc.terminate()
        for proc in started:
            proc.join(timeout=10)
            if proc.is_alive():
                proc.kill()
                proc.join()
        results.close()
        shutil.rmtree(workdir, ignore_errors=True)


def _collect(procs, results, deadline):
    """the ranks' results by rank, draining ``results`` before any join"""
    got = {}
    while len(got) < len(procs):
        try:
            rank, ok, value = results.get(timeout=0.2)
        except queue.Empty:
            dead = [
                (rank, proc.exitcode) for rank, proc in enumerate(procs)
                if rank not in got and proc.exitcode not in (None, 0)
            ]
            if not dead and time.monotonic() <= deadline:
                continue
            try:
                # a rank that failed has sent its traceback before exiting
                rank, ok, value = results.get(timeout=2)
            except queue.Empty:
                if dead:
                    raise RuntimeError(
                        f"rank {dead[0][0]} died with exit code {dead[0][1]}"
                    ) from None
                missing = sorted(set(range(len(procs))) - set(got))
                raise TimeoutError(
                    f"ranks {missing} overran their deadline"
                ) from None
        if not ok:
            raise RuntimeError(f"rank {rank} failed:\n{value}")
        got[rank] = value
    return [got[rank] for rank in range(len(procs))]
