"""The row-sharded index across processes: a launcher and one rank program.

:func:`spawn_ranks` starts ``world`` processes with the ``spawn`` method.
Each joins one ``torch.distributed`` group through a file store, with a time
limit on every collective, and runs ``target(rank, world, *args)``.  The
launcher waits for all of them and raises when one fails or the time limit
passes, ending the rest, so a hung collective fails its caller instead of
hanging it.

:func:`rank_program` is one rank of a sharded build and search over a
``("data",)`` mesh of ``S`` shards, ``S / world`` a process: it writes its
rows of the built graph, the global ring KNN of its rows, the mixed
sharded search's answer (the same on every rank), optionally that answer on
a two-axis mesh (hierarchical and flat merge), and the ring collectives on
known inputs, to ``out_dir/rank{rank}.npz``.  The multi-process tests and
``chip_smoke.py`` hold those files against one process's results::

    spawn_ranks(rank_program, 2, (inputs_npz, out_dir, params),
                backend="gloo", init_file=path_under_build_or_tmp)
"""
from __future__ import annotations

import datetime
import os
import pathlib
import time
from multiprocessing import resource_tracker

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.core.build import UGConfig
from repro_torch.core.sharded import (
    build_sharded_store, make_ring_knn_fn, make_sharded_search_fn, shard_index,
)
from repro_torch.distributed import ring_all_gather, ring_reduce_scatter
from repro_torch.launch.mesh import GROUP_TIMEOUT, make_mesh


def _rank_main(target, rank: int, world: int, backend: str, init_file: str,
               timeout: float, args: tuple) -> None:
    # a collective waits at most the launch's limit, and never past the
    # mesh groups' own
    limit = min(datetime.timedelta(seconds=timeout), GROUP_TIMEOUT)
    dist.init_process_group(backend, init_method=f"file://{init_file}", rank=rank,
                            world_size=world, timeout=limit)
    try:
        target(rank, world, *args)
    finally:
        dist.destroy_process_group()


def spawn_ranks(target, world: int, args: tuple = (), *, backend: str = "gloo",
                init_file, timeout: float = 120.0) -> None:
    """Run ``target(rank, world, *args)`` in ``world`` spawned processes of
    one process group (``init_file`` must not exist yet).  Raises
    ``RuntimeError`` when a process exits non-zero and ``TimeoutError``
    when they have not all ended after ``timeout`` seconds; either way no
    process is left running, the resource tracker that the launch started
    included."""
    init_file = pathlib.Path(init_file)
    if init_file.exists():
        raise FileExistsError(f"{init_file} exists: a file store needs a fresh file")
    ctx = mp.get_context("spawn")
    # the first spawned process starts multiprocessing's resource tracker,
    # which some Python 3.12 releases leave to outlive this process
    tracker_was_running = resource_tracker._resource_tracker._fd is not None
    procs = [ctx.Process(target=_rank_main,
                         args=(target, r, world, backend, str(init_file), timeout, args))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        while any(p.is_alive() for p in procs):
            failed = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
            if failed:
                raise RuntimeError(f"ranks {failed} of {world} failed "
                                   f"(exit codes {[procs[r].exitcode for r in failed]})")
            if time.monotonic() > deadline:
                raise TimeoutError(f"{world} ranks still running after {timeout} s")
            time.sleep(0.05)
        failed = [r for r, p in enumerate(procs) if p.exitcode != 0]
        if failed:
            raise RuntimeError(f"ranks {failed} of {world} failed "
                               f"(exit codes {[procs[r].exitcode for r in failed]})")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            p.join(timeout=10)
        if not tracker_was_running:
            resource_tracker._resource_tracker._stop()  # ends it and waits for it


def collective_inputs(mesh, axis: str, width: int = 3):
    """Known per-shard inputs of the ring collectives: shard ``g``'s block
    is ``100·g + [0, width)``; its reduce-scatter input is ``(size, width)``
    with chunk ``c`` ``100·g + 10·c + [0, width)``."""
    size = mesh.size(axis)
    g = torch.arange(mesh.start(axis), mesh.start(axis) + mesh.local(axis),
                     device=mesh.device, dtype=torch.float32)
    cols = torch.arange(width, device=mesh.device, dtype=torch.float32)
    blocks = 100.0 * g[:, None] + cols
    chunks = 100.0 * g[:, None, None] + 10.0 * torch.arange(
        size, device=mesh.device, dtype=torch.float32)[None, :, None] + cols
    return blocks, chunks


def rank_program(rank: int, world: int, inputs: str, out_dir: str, params: dict) -> None:
    """One rank of a sharded build and search (see the module docstring).

    ``inputs`` is an npz with ``x``, ``intervals``, ``qv``, ``qi`` and
    ``flags`` (and, for a two-axis search, the host arrays ``hx``, ``hi``,
    ``hn``, ``hs``, ``hg`` of every shard).  ``params``: ``device``,
    ``shards``, ``cfg`` (``UGConfig`` fields), ``ef``, ``k``, ``width``,
    ``ring_k``, ``threads`` (CPU threads; by default the host's cores
    split between the ranks) and ``mesh2`` (a ``(shape, axes)`` pair,
    optional)."""
    # processes that share a host share its cores: oversubscribed OpenMP
    # pools slow every rank down by orders of magnitude
    torch.set_num_threads(params.get("threads") or max(1, (os.cpu_count() or 1) // world))
    data = np.load(inputs)
    dev = params["device"]
    mesh = make_mesh((params["shards"],), ("data",), device=dev)
    sidx = build_sharded_store(mesh, data["x"], data["intervals"], UGConfig(**params["cfg"]))
    q = {name: torch.as_tensor(data[name], device=mesh.device) for name in ("qv", "qi", "flags")}
    search = dict(ef=params["ef"], k=params["k"], width=params["width"], mixed=True)
    ids, dist_ = make_sharded_search_fn(mesh, **search)(sidx, q["qv"], q["qi"], q["flags"])
    ring_i, ring_d = make_ring_knn_fn(mesh, k=params["ring_k"])(sidx.store.plane.data,
                                                               sidx.global_ids)
    blocks, chunks = collective_inputs(mesh, "data")
    _, gathered = ring_all_gather(blocks, mesh, "data")
    out = dict(nbrs=sidx.store.nbrs, status=sidx.store.status, gids=sidx.global_ids,
               ids=ids, dist=dist_, ring_ids=ring_i, ring_dist=ring_d,
               all_gather=gathered, reduce_scatter=ring_reduce_scatter(chunks, mesh, "data"))
    if params.get("mesh2"):
        shape, axes = params["mesh2"]
        mesh2 = make_mesh(shape, axes, device=dev)
        sidx2 = shard_index(mesh2, axes, *(data[a] for a in ("hx", "hi", "hn", "hs", "hg")))
        for hier in (True, False):
            fn = make_sharded_search_fn(mesh2, index_axes=axes, hierarchical=hier, **search)
            out[f"ids_hier{int(hier)}"], out[f"dist_hier{int(hier)}"] = fn(
                sidx2, q["qv"], q["qi"], q["flags"])
    np.savez(pathlib.Path(out_dir) / f"rank{rank}.npz",
             **{name: t.cpu().numpy() for name, t in out.items()})
