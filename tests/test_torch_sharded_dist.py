"""The row-sharded index across processes, on the CPU: gloo groups started
with ``spawn`` through a file store, every collective and every launch under
a time limit.

* world 2 (a ``(4,)`` ``data`` mesh, two shards a process) and world 4 (one
  shard a process): the device build's rows, the global ring KNN, the mixed
  sharded search, and on a ``(2, 2)`` ``(pod, data)`` mesh the hierarchical
  and flat merges are bitwise what one process holding all four shards
  computes;
* the ring collectives (``distributed/collectives.py``): in one process over
  eight shards, as the reference's ``test_ring_collectives`` checks them,
  and across processes bitwise the one-process result;
* a failed or hung rank fails its launch within the time limit, and a
  launch leaves no process running;
* ``FleetServeMonitor`` on the real probe functions of a sharded index
  (the reference's ``test_serve_fleet_monitor_on_sharded_index``).
"""
import concurrent.futures
import os
import pathlib
import time
from multiprocessing import resource_tracker

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.core import UGConfig
from repro_torch.core import intervals as iv
from repro_torch.core.sharded import (
    build_sharded_index_host, build_sharded_store, make_ring_knn_fn, make_shard_probe_fns,
    make_sharded_search_fn, shard_index,
)
from repro_torch.distributed import ring_all_gather, ring_reduce_scatter
from repro_torch.ft.straggler import StragglerConfig
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.sharded import collective_inputs, rank_program, spawn_ranks
from repro_torch.serve import FleetServeMonitor

N, D, S, NQ, RING_K = 402, 8, 4, 16, 8
CFG = dict(ef_spatial=8, ef_attribute=16, max_edges_if=8, max_edges_is=8, iterations=2,
           repair_width=4, exact_spatial=True, block=64)
SEARCH = dict(ef=16, k=5, width=4)
WORLDS = (2, 4)
TIMEOUT = 60.0
MESH2 = ((2, 2), ("pod", "data"))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def grid_intervals(rng, n):
    return np.sort(rng.integers(0, 17, (n, 2)), axis=-1).astype(np.float32) / 16


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One process's results, and each world's rank files (both worlds run
    side by side)."""
    rng = np.random.default_rng(21)
    x = rng.integers(-4, 5, (N, D)).astype(np.float32)
    ints = grid_intervals(rng, N)
    qv = rng.integers(-4, 5, (NQ, D)).astype(np.float32)
    qi = grid_intervals(rng, NQ)
    flags = np.asarray([iv.FLAG_IF, iv.FLAG_IS] * (NQ // 2), np.int32)
    q = [torch.as_tensor(a) for a in (qv, qi, flags)]

    mesh = make_mesh((S,), ("data",), device="cpu")
    sidx = build_sharded_store(mesh, x, ints, UGConfig(**CFG))
    st = sidx.store
    host = dict(hx=st.plane.data, hi=st.intervals, hn=st.nbrs, hs=st.status, hg=sidx.global_ids)
    ids, dist_ = make_sharded_search_fn(mesh, mixed=True, **SEARCH)(sidx, *q)
    ring_i, ring_d = make_ring_knn_fn(mesh, k=RING_K)(st.plane.data, sidx.global_ids)
    blocks, chunks = collective_inputs(mesh, "data")
    one = dict(nbrs=st.nbrs, status=st.status, gids=sidx.global_ids, ids=ids, dist=dist_,
               ring_ids=ring_i, ring_dist=ring_d,
               all_gather=ring_all_gather(blocks, mesh, "data")[1],
               reduce_scatter=ring_reduce_scatter(chunks, mesh, "data"))
    mesh2 = make_mesh(*MESH2, device="cpu")
    sidx2 = shard_index(mesh2, MESH2[1], *host.values())
    for hier in (True, False):
        fn = make_sharded_search_fn(mesh2, index_axes=MESH2[1], hierarchical=hier, mixed=True,
                                    **SEARCH)
        one[f"ids_hier{int(hier)}"], one[f"dist_hier{int(hier)}"] = fn(sidx2, *q)

    path = tmp_path_factory.mktemp("sharded_dist")
    inputs = path / "inputs.npz"
    np.savez(inputs, x=x, intervals=ints, qv=qv, qi=qi, flags=flags,
             **{k: v.numpy() for k, v in host.items()})
    params = dict(device="cpu", shards=S, cfg=CFG, ring_k=RING_K, threads=1, mesh2=MESH2,
                  **SEARCH)

    def launch(world):
        out = path / f"world{world}"
        out.mkdir()
        spawn_ranks(rank_program, world, (str(inputs), str(out), params), backend="gloo",
                    init_file=path / f"init{world}", timeout=TIMEOUT)
        return [dict(np.load(out / f"rank{r}.npz")) for r in range(world)]

    with concurrent.futures.ThreadPoolExecutor(len(WORLDS)) as pool:
        worlds = dict(zip(WORLDS, pool.map(launch, WORLDS)))
    return {k: v.numpy() for k, v in one.items()}, worlds


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("key", ["nbrs", "status", "gids", "ring_ids", "ring_dist",
                                 "all_gather", "reduce_scatter"])
def test_rows_across_processes_bitwise(runs, world, key):
    """Each rank's rows, in rank order, are one process's rows."""
    one, worlds = runs
    got = np.concatenate([r[key] for r in worlds[world]])
    assert got.dtype == one[key].dtype and np.array_equal(got, one[key]), key


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("search", ["", "_hier1", "_hier0"])
def test_search_across_processes_bitwise(runs, world, search):
    """Every rank returns one process's answer: the mixed search on the
    ``(4,)`` mesh, and both merges on the ``(2, 2)`` mesh."""
    one, worlds = runs
    for r in worlds[world]:
        assert np.array_equal(r[f"ids{search}"], one[f"ids{search}"])
        assert np.array_equal(r[f"dist{search}"].view(np.int32),
                              one[f"dist{search}"].view(np.int32))


def test_ring_collectives_one_process():
    """The reference's ``test_ring_collectives`` on ``distributed``'s ring,
    eight shards in one process."""
    mesh = make_mesh((8,), ("data",), device="cpu")
    g = torch.Generator().manual_seed(0)
    x = torch.randn(8, 4, generator=g)
    size, blocks = ring_all_gather(x, mesh, "data")
    assert size == 8 and blocks.shape == (8, 8, 4)
    # shard r's ring order starts at its own block and runs backwards
    assert torch.equal(blocks[0, 0], x[0])
    for r in range(8):
        for t in range(8):
            assert torch.equal(blocks[r, t], x[(r - t) % 8])
    y = torch.randn(8, 8, 4, generator=g)               # per shard: (8 chunks, 4)
    out = ring_reduce_scatter(y, mesh, "data")
    torch.testing.assert_close(out, y.sum(dim=0), atol=1e-5, rtol=0)


def test_ring_collectives_on_known_inputs(runs):
    """The gathered blocks and the reduced chunks are the arithmetic's."""
    one, _ = runs
    g = np.arange(S, dtype=np.float32)
    cols = np.arange(3, dtype=np.float32)
    blocks = 100 * g[:, None] + cols
    for r in range(S):
        for t in range(S):
            assert np.array_equal(one["all_gather"][r, t], blocks[(r - t) % S])
    want = 100 * g.sum() + 10 * g[:, None] * S + S * cols
    assert np.array_equal(one["reduce_scatter"], want)


def _fail_on_rank_one(rank, world):
    if rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    dist.barrier()


def _hang_on_rank_one(rank, world):
    if rank == 1:
        time.sleep(600)
    dist.barrier()


@pytest.mark.parametrize("target,error,timeout", [(_fail_on_rank_one, RuntimeError, TIMEOUT),
                                                  (_hang_on_rank_one, TimeoutError, 8.0)])
def test_failed_or_hung_rank_fails_the_launch(tmp_path, target, error, timeout):
    t0 = time.monotonic()
    with pytest.raises(error):
        spawn_ranks(target, 2, backend="gloo", init_file=tmp_path / "init", timeout=timeout)
    assert time.monotonic() - t0 < timeout + 15.0


def _children():
    """Pids of this process's child processes that still exist."""
    me = str(os.getpid())
    kids = []
    for proc in pathlib.Path("/proc").glob("[0-9]*"):
        try:
            stat = (proc / "stat").read_text()
        except OSError:
            continue
        if stat.rsplit(")", 1)[1].split()[1] == me:
            kids.append(int(proc.name))
    return kids


def test_launch_leaves_no_process(tmp_path):
    """Once ``spawn_ranks`` returns, neither a rank nor the resource
    tracker that the spawn started is running."""
    before = set(_children())
    spawn_ranks(_barrier, 2, backend="gloo", init_file=tmp_path / "init", timeout=TIMEOUT)
    assert set(_children()) <= before
    assert resource_tracker._resource_tracker._fd is None


def _barrier(rank, world):
    dist.barrier()


def test_fleet_monitor_on_real_probe_fns():
    """Probes run the per-shard program of the sharded step: the union of
    their top-k covers the sharded answer; a shard slowed 20× is flagged
    ``checkpoint_now`` and the degraded replica plan sheds its device group
    while keeping the shard axis."""
    rng = np.random.default_rng(0)
    n, d, nq, k = 1200, 12, 8, 10
    x = rng.normal(size=(n, d)).astype(np.float32)
    ints = np.sort(rng.uniform(size=(n, 2)), axis=-1).astype(np.float32)
    cfg = UGConfig(ef_spatial=16, ef_attribute=32, max_edges_if=16, max_edges_is=16,
                   iterations=2, repair_width=8, exact_spatial=True, block=512)
    mesh = make_mesh((S, 2), ("data", "model"), device="cpu")
    sidx = shard_index(mesh, ("data",), *build_sharded_index_host(x, ints, S, cfg, device="cpu"))
    qv = torch.as_tensor(rng.normal(size=(nq, d)).astype(np.float32))
    c = rng.uniform(size=(nq, 1))
    qi = torch.as_tensor(np.concatenate([np.maximum(c - 0.3, 0), np.minimum(c + 0.3, 1)],
                                        axis=1).astype(np.float32))
    flags = torch.as_tensor([iv.FLAG_IF if i % 2 else iv.FLAG_IS for i in range(nq)],
                            dtype=torch.int32)

    probe_fns = make_shard_probe_fns(sidx, S, ef=48, k=k)
    union = torch.cat([fn(qv, qi, flags)[0] for fn in probe_fns], dim=1)
    gids, _ = make_sharded_search_fn(mesh, ef=48, k=k, mixed=True)(sidx, qv, qi, flags)
    for q in range(nq):
        got = set(gids[q].tolist()) - {-1}
        assert got <= set(union[q].tolist()), q

    scfg = StragglerConfig()
    fm = FleetServeMonitor(n_shards=S, n_devices=8, cfg=scfg)
    for _ in range(scfg.warmup + scfg.baseline_min + scfg.recent):
        times = fm.probe(probe_fns, qv, qi, flags)
        assert len(times) == S and all(t > 0 for t in times)
    base = float(np.median([np.median(t._recent()) for t in fm.fleet.timers]))
    for _ in range(2 * scfg.recent):
        for s in range(S):
            fm.record(s, 20.0 * base if s == 2 else base)
    rep = fm.report()
    assert rep["stragglers"] == [2], rep["stragglers"]
    assert rep["recommendations"].get(2) == "checkpoint_now"
    assert rep["plan"].mesh_shape == (2, S)
    assert rep["degraded_plan"] is not None
    assert rep["degraded_plan"].mesh_shape == (1, S)
    assert rep["degraded_plan"].dropped_pods == 2
