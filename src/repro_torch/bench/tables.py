"""One bench function per paper table, as in the reference's
``benchmarks/tables.py``, with the same row names.

Each returns rows (``common.row``): name, us_per_call, derived, and the
unrounded metrics behind ``derived``.  Every table of the reference's index
half is here: Exp-1 to Exp-7, the fused-against-legacy beam sweep, the
mixed workload, the build and memory tiers, the streaming updates, the
serve runtime and the kernel table.  A backend in a row name takes the
port's name for the reference's role (``xla`` → ``torch``, ``pallas`` →
``cuda``; ``legacy`` stays); the CPU runs ``legacy`` and ``torch``, the
card ``cuda`` as well, so every row of a CPU run also comes out of a card
run.  A timing key says where it was taken (``cpu_qps`` or ``gpu_qps``).
"""
from __future__ import annotations

import dataclasses
import statistics
import time

import numpy as np
import torch

from repro_torch.bench import common
from repro_torch.core import Semantics, SearchResult, UGConfig, UGIndex, recall
from repro_torch.core import intervals as iv_mod
from repro_torch.core.baselines import prefilter_search
from repro_torch.core.build import build_ug
from repro_torch.kernels import ops
from repro_torch.kernels.beam_merge import merge_comparator_count
from repro_torch.kernels.expand_score import expand_score_legacy
from repro_torch.kernels.util import no_tf32, resolve_device


SERVE_TIMED_SECONDS = 1.0   # bench_serve: timed seconds a path takes at least ...
SERVE_MAX_PASSES = 7        # ... in at most this many passes


def fused_backends(dev) -> tuple:
    """The fused path's backends: the plain versions, and on the card the
    kernels too."""
    return ("torch", "cuda") if dev.type == "cuda" else ("torch",)


def profile_backends(dev) -> tuple:
    """The memory profiles' and the build table's backends: the legacy
    baseline and the fused path's."""
    return ("legacy",) + fused_backends(dev)


def _qps_row(name: str, nq: int, dt: float, r: float) -> dict:
    qps = nq / dt
    return common.row(name, 1e6 * dt / nq, f"recall={r:.3f} qps={qps:.0f}", qps=qps, recall=r)


# ---------------------------------------------------------------- Exp-1 / Fig 6
def bench_ifann(b: common.Bench):
    """IFANN QPS–recall trade-off: UG vs post-filter vs Hi-PNG vs pre-filter."""
    rows = []
    dev = b.device
    qv, qi = b.queries("uniform")
    ug = b.ug_index()
    pf = b.postfilter_index()
    hp = b.hipng_index()
    gt = ug.ground_truth(qv, qi, sem=Semantics.IF, k=10)
    nq = qv.shape[0]

    for ef in (16, 32, 64, 128):
        qps, r = common.qps_recall(ug, qv, qi, sem=Semantics.IF, ef=ef, truth=gt)
        rows.append(_qps_row(f"ifann_ug_ef{ef}", nq, nq / qps, r))
    for ef in (32, 128):
        dt, res = common.timed(
            lambda: pf.search(qv, qi, sem=Semantics.IF, ef=ef, k=10, oversample=8), device=dev)
        rows.append(_qps_row(f"ifann_postfilter_ef{ef}", nq, dt, recall(res, gt)))
    dt, res = common.timed(lambda: hp.search(qv, qi, ef=64, k=10), device=dev)
    rows.append(_qps_row("ifann_hipng_ef64", nq, dt, recall(res, gt)))
    x, ints = b.corpus()
    dt, res = common.timed(
        lambda: prefilter_search(x, ints, qv, qi, sem=Semantics.IF, k=10), device=dev)
    rows.append(_qps_row("ifann_prefilter_exact", nq, dt, recall(res, gt)))
    return rows


# ---------------------------------------------------------------- Exp-2 / Fig 7
def bench_query_types(b: common.Bench):
    """One UG index answering all four semantics (the paper's headline)."""
    rows = []
    ug = b.ug_index()
    qv, qi = b.queries("uniform")
    _, qpoint = b.queries("point")
    for sem, q in [(Semantics.IF, qi), (Semantics.IS, qi), (Semantics.RS, qpoint),
                   (Semantics.RF, qi)]:
        qps, r = common.qps_recall(ug, qv, q, sem=sem, ef=96)
        rows.append(_qps_row(f"qtype_{sem.value.lower()}", qv.shape[0], qv.shape[0] / qps, r))
    return rows


# ---------------------------------------------------------------- Exp-3 / Fig 10
def bench_workloads(b: common.Bench):
    """IFANN under short/long/mixed/uniform selectivity workloads."""
    rows = []
    ug = b.ug_index()
    for w in ("short", "long", "mixed", "uniform"):
        qv, qi = b.queries(w)
        qps, r = common.qps_recall(ug, qv, qi, sem=Semantics.IF, ef=96)
        rows.append(_qps_row(f"workload_{w}", qv.shape[0], qv.shape[0] / qps, r))
    return rows


# ---------------------------------------------------------------- Exp-4 / Fig 8+9
def bench_indexing(b: common.Bench):
    """Index construction time and memory for UG vs baselines."""
    rows = []
    ug = b.ug_index()
    sec, nbytes = ug.build_seconds, ug.memory_bytes()
    rows.append(common.row("index_build_ug", sec * 1e6, f"seconds={sec:.1f} bytes={nbytes:,}",
                           seconds=sec, bytes=nbytes))
    pf = b.postfilter_index()
    sec, nbytes = pf.build_seconds, pf.memory_bytes()
    rows.append(common.row("index_build_postfilter", sec * 1e6,
                           f"seconds={sec:.1f} bytes={nbytes:,}", seconds=sec, bytes=nbytes))
    hp = b.hipng_index()
    sec, nbytes, parts = hp.build_seconds, hp.memory_bytes(), len(hp.partitions)
    rows.append(common.row("index_build_hipng", sec * 1e6,
                           f"seconds={sec:.1f} bytes={nbytes:,} partitions={parts}",
                           seconds=sec, bytes=nbytes, partitions=parts))
    d = ug.degree_stats()
    rows.append(common.row(
        "index_degrees_ug", 0.0,
        f"mean_if={d['mean_if']:.1f} mean_is={d['mean_is']:.1f} edges={d['edges']}", **d))
    return rows


# ---------------------------------------------------------------- Exp-5 / Fig 12
def bench_k(b: common.Bench):
    rows = []
    ug = b.ug_index()
    qv, qi = b.queries("uniform")
    for k in (1, 10, 20, 50):
        qps, r = common.qps_recall(ug, qv, qi, sem=Semantics.IF, ef=max(96, 2 * k), k=k)
        rows.append(_qps_row(f"vary_k_{k}", qv.shape[0], qv.shape[0] / qps, r))
    return rows


# ---------------------------------------------------------------- Exp-6 / Fig 11
def bench_sensitivity(b: common.Bench):
    """Build-parameter sensitivity: twelve exact-candidate builds of ``b``'s
    corpus, one parameter varied at a time, each searched at ef 64."""
    rows = []
    x, ints = b.corpus()
    qv, qi = b.queries("uniform")
    base = dict(ef_spatial=24, ef_attribute=48, max_edges_if=24, max_edges_is=24,
                iterations=2, repair_width=8, exact_spatial=True, block=1024)

    def build_and_eval(tag, **kw):
        idx = UGIndex.build(x, ints, UGConfig(**{**base, **kw}), device=b.device)
        qps, r = common.qps_recall(idx, qv, qi, sem=Semantics.IF, ef=64)
        sec = idx.build_seconds
        rows.append(common.row(f"sens_{tag}", sec * 1e6,
                               f"recall={r:.3f} qps={qps:.0f} build_s={sec:.1f}",
                               recall=r, qps=qps, build_s=sec))

    for efa in (16, 48, 96):
        build_and_eval(f"ef_attr_{efa}", ef_attribute=efa)
    for efs in (8, 24, 48):
        build_and_eval(f"ef_spatial_{efs}", ef_spatial=efs)
    for it in (1, 2, 4):
        build_and_eval(f"iters_{it}", iterations=it)
    for me in (8, 24, 48):
        build_and_eval(f"max_edges_{me}", max_edges_if=me, max_edges_is=me)
    return rows


# ---------------------------------------------------------------- Exp-7 / Fig 13
def bench_scalability(b: common.Bench, sizes=common.SCALABILITY_SIZES):
    """IF QPS and recall at ef 64 against corpus size; ``b`` answers for
    its own size (its index is reused), the others are built with the
    default config for their size."""
    rows = []
    for n in sizes:
        bn = b.resized(n)
        idx = bn.ug_index()
        qv, qi = bn.queries("uniform")
        qps, r = common.qps_recall(idx, qv, qi, sem=Semantics.IF, ef=64)
        sec = idx.build_seconds
        rows.append(common.row(f"scale_n{n}", 1e6 / qps,
                               f"recall={r:.3f} qps={qps:.0f} build_s={sec:.1f}",
                               recall=r, qps=qps, build_s=sec, n=n))
    return rows


def _wall(dev) -> str:
    """The prefix of a wall-clock key: where it was taken."""
    return "gpu" if dev.type == "cuda" else "cpu"


# ------------------------------------------------- fused multi-expansion sweep
def bench_beam_sweep(b: common.Bench):
    """QPS against recall of the fused multi-expansion search (W = 4) and
    the legacy one-node-per-step loop (W = 1), under all four semantics at
    ef 32 and 96.

    ``merge_cmp_per_expansion`` is the merge's comparator count per
    expansion (``merge_comparator_count``): the fused path's must be
    strictly below legacy's (no full ``(ef + M)`` argsort in the loop).
    Each row is one warm-up call and one timed call."""
    dev = b.device
    rows = []
    ug = b.ug_index()
    qv, qi = b.queries("uniform")
    _, qpoint = b.queries("point")
    nq = qv.shape[0]
    M = ug.graph.nbrs.shape[1]
    width = 4
    for sem, q in [(Semantics.IF, qi), (Semantics.IS, qi), (Semantics.RS, qpoint),
                   (Semantics.RF, qi)]:
        gt = ug.ground_truth(qv, q, sem=sem, k=10)
        for ef in (32, 96):
            cmps = {}
            for backend in profile_backends(dev):
                w = 1 if backend == "legacy" else width
                dt, res = common.timed(
                    lambda: ug.search(qv, q, sem=sem, ef=ef, k=10, backend=backend, width=w),
                    device=dev, calls=(1, 1))
                r = recall(res, gt)
                cmps[backend] = merge_comparator_count(ef, M, width=w,
                                                       fused=backend != "legacy")
                hops = float(res.steps.float().mean())
                rows.append(common.row(
                    f"beam_{sem.value.lower()}_{backend}_ef{ef}", 1e6 * dt / nq,
                    f"recall={r:.3f} qps={nq / dt:.0f} hops={hops:.1f} "
                    f"merge_cmp_per_expansion={cmps[backend]:.0f}",
                    recall=r, qps=nq / dt, hops=hops, iters=res.iters,
                    merge_cmp_per_expansion=cmps[backend]))
            if not all(cmps[f] < cmps["legacy"] for f in fused_backends(dev)):
                raise AssertionError(f"fused merge comparators {cmps} not below legacy's")
    return rows


# ------------------------------------------------- mixed-workload serving
def bench_mixed_workload(b: common.Bench, require_speedup=None):
    """One interleaved IF/IS/RF/RS batch through the mixed search against
    the same traffic as four per-semantics quarter batches, at ef 96.

    The batch-synchronous latency is (loop iterations) × (step latency), so
    the interleaved schedule's gain is ``Σ_s iters_s / iters_mixed``
    (``sync_speedup_interleaved``), from the searches' iteration counts;
    ``require_speedup`` asserts it.  The wall-clock QPS of both schedules
    stands beside it.  Also asserted: one fused search step forms no
    ``(B, C, d)`` gather and no ``(·, C, C)`` dedup tensor (the legacy
    expand/dedup pair does; ``search_step_memory_profile``), and the mixed
    batch answers every query bitwise as its per-semantics batch does."""
    from repro_torch.core.search import search_step_memory_profile

    dev = b.device
    wall = _wall(dev)
    rows = []
    for backend in profile_backends(dev):
        prof = search_step_memory_profile(backend)
        if backend != "legacy" and (prof["bcd_gather"] or prof["cc_pairwise"]):
            raise AssertionError(f"{backend} search step materializes a quadratic intermediate")
        rows.append(common.row(
            f"mixed_step_profile_{backend}", 0.0,
            f"peak_intermediate_bytes={prof['peak_bytes']} "
            f"bcd_gather={'yes' if prof['bcd_gather'] else 'no'} "
            f"cc_dedup={'yes' if prof['cc_pairwise'] else 'no'}", **prof))

    ug = b.ug_index()
    qv, qi = b.queries("uniform")
    _, qpoint = b.queries("point")
    nq = qv.shape[0]
    cycle = [Semantics.IF, Semantics.IS, Semantics.RS, Semantics.RF]
    sems = [cycle[i % 4] for i in range(nq)]
    is_rs = torch.tensor([s is Semantics.RS for s in sems], device=dev)
    qm = torch.where(is_rs[:, None], qpoint, qi)
    subsets = {s: torch.tensor([i for i, ss in enumerate(sems) if ss is s], device=dev)
               for s in cycle}
    ef = 96

    dt_mixed, res_mixed = common.timed(lambda: ug.search_mixed(qv, qm, sems, ef=ef, k=10),
                                       device=dev)
    dt_split, res_split = common.timed(
        lambda: {s: ug.search(qv[sel], qm[sel], sem=s, ef=ef, k=10) for s, sel in subsets.items()},
        device=dev)

    recalls = {}
    for s, sel in subsets.items():
        part = SearchResult(res_mixed.ids[sel], res_mixed.dist[sel], res_mixed.steps[sel])
        recalls[s] = recall(part, ug.ground_truth(qv[sel], qm[sel], sem=s, k=10))
        one = res_split[s]
        if not (torch.equal(part.ids, one.ids)
                and torch.equal(part.dist.view(torch.int32), one.dist.view(torch.int32))):
            raise AssertionError(f"mixed batch != per-semantics batch for {s.value}")

    iters_mixed = res_mixed.iters
    iters_split = sum(res_split[s].iters for s in cycle)
    sync_speedup = iters_split / max(iters_mixed, 1)
    wall_speedup = dt_split / dt_mixed
    hops = float(res_mixed.steps.float().mean())
    rec = " ".join(f"recall_{s.value.lower()}={recalls[s]:.3f}" for s in cycle)
    rows.append(common.row(
        "mixed_interleaved_4sem", 1e6 * dt_mixed / nq,
        f"{wall}_qps={nq / dt_mixed:.0f} sync_iters={iters_mixed} {rec} hops={hops:.1f}",
        **{f"{wall}_qps": nq / dt_mixed, "sync_iters": iters_mixed, "hops": hops},
        **{f"recall_{s.value.lower()}": recalls[s] for s in cycle}))
    rows.append(common.row(
        "mixed_split_4x_per_sem", 1e6 * dt_split / nq,
        f"{wall}_qps={nq / dt_split:.0f} sync_iters={iters_split} "
        f"sync_speedup_interleaved={sync_speedup:.2f}x {wall}_wall_speedup={wall_speedup:.2f}x",
        **{f"{wall}_qps": nq / dt_split, "sync_iters": iters_split,
           "sync_speedup_interleaved": sync_speedup, f"{wall}_wall_speedup": wall_speedup}))
    if require_speedup is not None and sync_speedup < require_speedup:
        raise AssertionError(
            f"interleaved mixed batch only {sync_speedup:.2f}x fewer batch-synchronous "
            f"iterations than four per-semantics batches (need >= {require_speedup}x)")
    return rows


# ------------------------------------------------- construction-cost sweep
def graph_checksum(graph) -> int:
    """The sum of a graph's neighbour ids and status bytes: equal graphs,
    equal sums (the bench's cross-backend guard)."""
    return int(graph.nbrs.to(torch.int64).sum()) + int(graph.status.to(torch.int64).sum())


def bench_build(sizes=common.BUILD_SIZES, *, dim: int = common.DIM, device=None):
    """Construction cost by prune backend against n.

    The ``build_sweep_profile_*`` rows record one sweep at the build's block
    shape (``cfg.block`` rows, the iteration-0 pool width;
    ``sweep_memory_profile``): the fused sweeps form no ``(B, C, C)`` tensor
    (asserted), the legacy sweep forms its distance and Φ tensors.  Each
    ``build_{backend}_n{n}`` row is one timed build with its graph checksum,
    which must be equal across backends.  ``build_sharded_n{n}`` builds the
    largest size through ``build_sharded_store``, one shard for each local
    device, on a pq plane."""
    from repro_torch.core.candidates import candidate_pool_width
    from repro_torch.core.sharded import build_sharded_store
    from repro_torch.kernels.prune_sweep import sweep_memory_profile
    from repro_torch.launch.mesh import make_mesh

    dev = resolve_device(device)
    no_tf32()
    cfg_base = common.UG_CFG
    pool_c = candidate_pool_width(cfg_base.ef_spatial, cfg_base.ef_attribute)
    backends = profile_backends(dev)
    rows, profiles = [], {}
    for backend in backends:
        prof = sweep_memory_profile(backend, B=cfg_base.block, C=pool_c, d=dim,
                                    m_if=cfg_base.max_edges_if, m_is=cfg_base.max_edges_is)
        if backend != "legacy" and prof["quadratic"]:
            raise AssertionError(f"{backend} sweep materializes a (B, C, C) tensor")
        profiles[backend] = prof
        rows.append(common.row(
            f"build_sweep_profile_{backend}", 0.0,
            f"peak_intermediate_bytes={prof['peak_bytes']} "
            f"phi_materialized={'yes' if prof['quadratic'] else 'no'}", **prof))

    for n in sizes:
        x, ints = common.Bench(n, dim, device=dev).corpus()
        sums = {}
        for backend in backends:
            cfg = dataclasses.replace(cfg_base, prune_backend=backend)
            gen = torch.Generator(device=dev).manual_seed(0)
            dt, graph = common.timed(lambda: build_ug(gen, x, ints, cfg), device=dev,
                                     calls=(0, 1))
            sums[backend] = graph_checksum(graph)
            edges = int((graph.nbrs >= 0).sum())
            peak = profiles[backend]["peak_bytes"]
            rows.append(common.row(
                f"build_{backend}_n{n}", dt * 1e6,
                f"seconds={dt:.1f} edges={edges} graph_checksum={sums[backend]} "
                f"peak_sweep_bytes={peak}",
                seconds=dt, edges=edges, graph_checksum=sums[backend], peak_sweep_bytes=peak))
        if len(set(sums.values())) != 1:
            raise AssertionError(f"prune backends build different graphs at n = {n}: {sums}")

    n_sh = max(sizes)
    shards = torch.cuda.device_count() if dev.type == "cuda" else 1
    x, ints = common.Bench(n_sh, dim, device=dev).corpus()
    mesh = make_mesh((shards,), ("data",), device=dev)
    dt, sidx = common.timed(lambda: build_sharded_store(mesh, x, ints, cfg_base, dtype="pq"),
                            device=dev, calls=(0, 1))
    n_rows = int(sidx.global_ids.shape[0])
    rows.append(common.row(
        f"build_sharded_n{n_sh}", dt * 1e6,
        f"seconds={dt:.1f} shards={shards} rows={n_rows} dtype=pq",
        seconds=dt, shards=shards, rows=n_rows))
    return rows


# ------------------------------------------------- streaming updates (churn)
def bench_updates(b: common.Bench, churn: float = 0.1, require_recall_gap=None):
    """Streaming updates: churn throughput and recall against a fresh
    rebuild under all four semantics.

    Deletes ``churn·n`` random nodes (tombstone and repair), inserts
    ``churn·n`` Gaussian rows with uniform intervals, and compares
    recall@10 of the mutated index with a build over the same live corpus.
    ``require_recall_gap`` asserts ``recall_mutated ≥ recall_fresh − gap``
    a semantics.  The memory profile of the insert and repair steps must
    show no ``(·, C, C)`` witness or dedup tensor and no ``(B, C, d)``
    gather on the plain versions, nor (on the card) on the kernels; the
    ``legacy`` row (the pre-fusion sweep, search and scorer) shows both."""
    from repro_torch.core.updates import update_memory_profile

    dev = b.device
    rows = []
    for backend in profile_backends(dev):
        prof = update_memory_profile(backend)
        if backend != "legacy" and (prof["quadratic_cc"] or prof["gather_bcd"]):
            raise AssertionError(f"{backend} update path materializes a quadratic intermediate")
        rows.append(common.row(
            f"updates_profile_{backend}", 0.0,
            f"peak_intermediate_bytes={prof['peak_bytes']} "
            f"cc_witness={'yes' if prof['quadratic_cc'] else 'no'} "
            f"bcd_gather={'yes' if prof['gather_bcd'] else 'no'}", **prof))

    x, ints = b.corpus()
    n = x.shape[0]
    nb = max(int(n * churn), 1)
    g = torch.Generator().manual_seed(1234)             # the CPU's: equal on every device
    new_x = torch.randn(nb, x.shape[1], generator=g).to(dev)
    new_iv = iv_mod.sample_uniform_intervals(g, nb).to(dev)
    dels = np.random.default_rng(42).choice(n, size=nb, replace=False).astype(np.int32)
    idx0 = b.ug_index()

    dt_del, idx_d = common.timed(lambda: idx0.delete(dels), device=dev)
    dt_ins, idx_m = common.timed(lambda: idx_d.insert(new_x, new_iv), device=dev)
    rows.append(common.row(
        "updates_delete_batch", 1e6 * dt_del / nb,
        f"deletes_per_s={nb / dt_del:.0f} batch={nb} live={idx_m.n}",
        seconds=dt_del, batch=nb, live=idx_m.n))
    rows.append(common.row(
        "updates_insert_batch", 1e6 * dt_ins / nb,
        f"inserts_per_s={nb / dt_ins:.0f} batch={nb} capacity={idx_m.capacity}",
        seconds=dt_ins, batch=nb, capacity=idx_m.capacity))

    # a fresh build over the mutated corpus: the recall yardstick
    keep = torch.as_tensor(np.setdiff1d(np.arange(n), dels), device=dev)
    idx_f = UGIndex.build(torch.cat([x[keep], new_x]), torch.cat([ints[keep], new_iv]),
                          b.config, device=dev)
    qv, qi = b.queries("uniform")
    _, qpoint = b.queries("point")
    worst = 0.0
    for sem, q in [(Semantics.IF, qi), (Semantics.IS, qi), (Semantics.RS, qpoint),
                   (Semantics.RF, qi)]:
        dt_q, res = common.timed(lambda: idx_m.search(qv, q, sem=sem, ef=96, k=10), device=dev)
        r_mut = recall(res, idx_m.ground_truth(qv, q, sem=sem, k=10))
        r_fresh = recall(idx_f.search(qv, q, sem=sem, ef=96, k=10),
                         idx_f.ground_truth(qv, q, sem=sem, k=10))
        gap = r_fresh - r_mut
        worst = max(worst, gap)
        qps = qv.shape[0] / dt_q
        rows.append(common.row(
            f"updates_churn_{sem.value.lower()}", 1e6 * dt_q / qv.shape[0],
            f"recall={r_mut:.3f} recall_fresh_rebuild={r_fresh:.3f} gap={gap:+.3f} "
            f"qps={qps:.0f}", recall=r_mut, recall_fresh_rebuild=r_fresh, gap=gap, qps=qps))
    if require_recall_gap is not None and worst > require_recall_gap:
        raise AssertionError(f"churned-index recall trails a fresh rebuild by {worst:.3f} "
                             f"(allowed {require_recall_gap})")
    return rows


# ------------------------------------------------- vector-plane memory tiers
def bench_memory(b: common.Bench, require_reduction=None, require_pq_reduction=8.0):
    """Bytes a vector against recall against QPS for each scan plane.

    One graph, six stores: the f32 plane, its bf16, int8 and pq re-encodings
    and int8 and pq with the exact f32 rerank plane (each quantized plane is
    encoded once and served with and without its rerank plane).  Recall is
    against the f32 exact truth, IF at ef 96.  Plane bytes include the
    codebooks and parameters over the live rows.  ``require_reduction``
    asserts int8's scan bytes at least that factor below f32's and int8 +
    rerank's recall within 0.02 of f32's; ``require_pq_reduction`` asserts
    the pq codes at least that factor below the f32 rows and pq + rerank's
    recall within 0.05."""
    dev = b.device
    rows = []
    ug = b.ug_index()
    qv, qi = b.queries("uniform")
    nq = qv.shape[0]
    gt = ug.ground_truth(qv, qi, sem=Semantics.IF, k=10)
    int8_rr = ug.with_dtype("int8", rerank=True)
    pq_rr = ug.with_dtype("pq", rerank=True)
    variants = [
        ("f32", ug),
        ("bf16", ug.with_dtype("bf16")),
        ("int8", int8_rr.with_store(int8_rr.store.replace(rerank=None))),
        ("int8_rerank", int8_rr),
        ("pq", pq_rr.with_store(pq_rr.store.replace(rerank=None))),
        ("pq_rerank", pq_rr),
    ]
    recalls, plane_b = {}, {}
    for tag, idx in variants:
        dt, res = common.timed(lambda idx=idx: idx.search(qv, qi, sem=Semantics.IF, ef=96, k=10),
                               device=dev)
        recalls[tag] = r = recall(res, gt)
        plane_b[tag] = idx.store.plane.bytes_per_vector(idx.n)
        rr = idx.store.rerank
        rr_b = 0 if rr is None else rr.bytes_per_vector(idx.n)
        rows.append(common.row(
            f"memory_{tag}", 1e6 * dt / nq,
            f"recall={r:.3f} plane_bytes={plane_b[tag]:.0f} rerank_bytes={rr_b:.0f} "
            f"qps={nq / dt:.0f}",
            recall=r, plane_bytes=plane_b[tag], rerank_bytes=rr_b, qps=nq / dt))
    reduction = plane_b["f32"] / plane_b["int8_rerank"]
    gap = recalls["f32"] - recalls["int8_rerank"]
    pq_codes = pq_rr.store.plane.data.numel()
    pq_code_red = plane_b["f32"] * ug.n / pq_codes          # codes only, no codebooks
    pq_gap = recalls["f32"] - recalls["pq_rerank"]
    rows.append(common.row(
        "memory_summary", 0.0,
        f"int8_scan_reduction={reduction:.2f} int8_rerank_recall_gap={gap:+.3f} "
        f"pq_code_reduction={pq_code_red:.2f} pq_rerank_recall_gap={pq_gap:+.3f}",
        int8_scan_reduction=reduction, int8_rerank_recall_gap=gap,
        pq_code_reduction=pq_code_red, pq_rerank_recall_gap=pq_gap))
    if require_reduction is not None:
        if reduction < require_reduction:
            raise AssertionError(f"int8 scan plane only {reduction:.2f}x below f32 bytes/vector "
                                 f"(need >= {require_reduction}x)")
        if gap > 0.02:
            raise AssertionError(f"int8+rerank trails f32 recall by {gap:.3f} (allowed 0.02)")
    if require_pq_reduction is not None:
        if pq_code_red < require_pq_reduction:
            raise AssertionError(f"pq codes only {pq_code_red:.2f}x below f32 rows "
                                 f"(need >= {require_pq_reduction}x)")
        if pq_gap > 0.05:
            raise AssertionError(f"pq+rerank trails f32 recall by {pq_gap:.3f} (allowed 0.05)")
    return rows


# ------------------------------------------------------- async serve runtime
def bench_serve(b: common.Bench, nreq: int = 256, batch: int = 64, require_qps_ratio=None):
    """The continuous-batching runtime against the sync batched path on a
    churning mixed IF/IS/RF/RS workload.

    One request stream, served twice from the same index: the sync path
    runs FIFO batches of ``batch`` through ``retrieve_mixed`` (blocking a
    batch), the async path submits the same requests one at a time to a
    threaded :class:`~repro_torch.serve.ServeRuntime`.  Halfway, both apply
    the same write (a remove and an upsert of ``n // 20`` rows).  Updates
    are deterministic, so both paths' post-write snapshots are equal, and
    the consistency metrics are exact:

    * ``recall_vs_pinned_snapshot``: the share of async replies bitwise
      equal to a direct padded ``search_mixed`` on their pinned snapshot
      (1.0 = no torn reads);
    * ``recall_async_eq_sync``: the share of requests whose async and sync
      answers agree bitwise (continuous batching is exact);
    * ``recall_pre``/``recall_post``: recall@10 of each half of the stream
      against its own snapshot's exact truth.

    The async client submits every request at once (no arrival rate), so
    the runtime row's p50/p99 measure queue position, not a user's latency
    at a given load.  Both paths are warmed up first, and each QPS is the
    median over passes in turns (sync, async, async, sync, ...) until a
    path has :data:`SERVE_TIMED_SECONDS` of them (at most
    :data:`SERVE_MAX_PASSES`; the first passes are the ones checked).
    ``require_qps_ratio`` asserts ``qps_async ≥ ratio · qps_sync``."""
    from repro_torch.data import CorpusConfig, make_queries
    from repro_torch.serve import RuntimeConfig, ServeEngine, ServeRuntime
    from repro_torch.serve.runtime import count_pinned_matches

    dev = b.device
    ef, k = 64, 10
    x, _ = b.corpus()
    n = x.shape[0]
    idx0 = b.ug_index()

    cycle = [Semantics.IF, Semantics.IS, Semantics.RS, Semantics.RF]
    sems = [cycle[i % 4] for i in range(nreq)]
    ccfg = CorpusConfig(n=b.n, dim=b.dim)
    qv, q_wide = (t.to(dev) for t in make_queries(ccfg, nreq, workload="uniform", device="cpu"))
    q_point = make_queries(ccfg, nreq, workload="point", device="cpu")[1].to(dev)
    flags = iv_mod.as_sem_flags(sems, nreq, device=dev)
    is_rs = torch.tensor([s is Semantics.RS for s in sems], device=dev)
    qw = torch.where(is_rs[:, None], q_point, q_wide)

    b_churn = max(n // 20, 8)
    dels = np.random.default_rng(77).choice(n, size=b_churn, replace=False).astype(np.int32)
    g = torch.Generator().manual_seed(4321)
    new_x = torch.randn(b_churn, x.shape[1], generator=g).to(dev)
    new_iv = iv_mod.sample_uniform_intervals(g, b_churn).to(dev)
    mid = (nreq // batch // 2) * batch

    def serve_sync(engine):
        """FIFO batches, blocking a batch; the write between two batches."""
        out_ids, out_dist = [], []
        t0 = time.perf_counter()
        for s in range(0, nreq, batch):
            if s == mid:
                engine.remove(dels)
                engine.upsert(None, new_iv, x=new_x)
            res = engine.retrieve_mixed(None, qw[s:s + batch], sems[s:s + batch], ef=ef, k=k,
                                        q_v=qv[s:s + batch])
            out_ids.append(res.ids.cpu().numpy())          # blocks: sync semantics
            out_dist.append(res.dist.cpu().numpy())
        dt = time.perf_counter() - t0
        return np.concatenate(out_ids), np.concatenate(out_dist), dt

    # requests arrive as rows in host memory; made before the clock starts
    q_rows, w_rows = qv.cpu().numpy(), qw.cpu().numpy()

    # warm-up on a scratch engine, through both paths, so that neither timed
    # pass pays a one-time cost: the kernels' library, the allocator, and the
    # runtime's pinned host buffers and events
    scratch = ServeEngine(index=idx0)
    scratch.retrieve_mixed(None, qw[:batch], sems[:batch], ef=ef, k=k, q_v=qv[:batch])
    with ServeRuntime(scratch, RuntimeConfig(max_batch=batch)) as rt:
        for f in [rt.submit(q_rows[i], w_rows[i], sems[i], ef=ef, k=k) for i in range(batch)]:
            f.result(timeout=600)
    common.synchronize(dev)

    def serve_async(engine):
        """Single-row submissions to a threaded runtime, the write halfway."""
        t0 = time.perf_counter()
        with ServeRuntime(engine, RuntimeConfig(max_batch=batch)) as rt:
            futs, wfuts = [], []
            for i in range(nreq):
                if i == mid:
                    wfuts.append(rt.submit_remove(dels))
                    wfuts.append(rt.submit_upsert(new_x, new_iv))
                futs.append(rt.submit(q_rows[i], w_rows[i], sems[i], ef=ef, k=k,
                                      deadline=rt.clock() + 300.0))
            replies = [f.result(timeout=600) for f in futs]
            stats = rt.stats()
        return replies, stats, wfuts, time.perf_counter() - t0

    # the first pass of each path is the one checked below; more passes, in
    # turns, until each path has SERVE_TIMED_SECONDS of them: one pass of a
    # small stream is too short for a stable ratio
    ids_sync, dist_sync, dt = serve_sync(ServeEngine(index=idx0))
    t_sync = [dt]
    eng_async = ServeEngine(index=idx0)
    replies, stats, wfuts, dt = serve_async(eng_async)
    t_async = [dt]
    while sum(t_sync) < SERVE_TIMED_SECONDS and len(t_sync) < SERVE_MAX_PASSES:
        for path in (("async", "sync") if len(t_sync) % 2 else ("sync", "async")):
            if path == "sync":
                t_sync.append(serve_sync(ServeEngine(index=idx0))[2])
            else:
                t_async.append(serve_async(ServeEngine(index=idx0))[3])
    dt_sync, dt_async = statistics.median(t_sync), statistics.median(t_async)
    qps_sync, qps_async = nreq / dt_sync, nreq / dt_async
    if not (all(w.result(timeout=5) == b_churn for w in wfuts)
            and stats["rejected"] == 0 and stats["writes"] == 2):
        raise AssertionError(f"async serve: writes or rejections off: {stats}")

    # consistency: every async reply equals a direct search on its pinned
    # snapshot, and async equals sync a request (both bitwise)
    frac_pinned = count_pinned_matches(replies, qv, qw, flags, ef=ef, k=k) / nreq
    frac_eq = sum(np.array_equal(r.ids, ids_sync[i])
                  and np.array_equal(r.dist.view(np.int32), dist_sync[i].view(np.int32))
                  for i, r in enumerate(replies)) / nreq
    if frac_pinned != 1.0:
        raise AssertionError(f"torn read: only {frac_pinned:.3f} of async replies match a "
                             f"direct search on their pinned snapshot")
    if frac_eq != 1.0:
        raise AssertionError(f"async/sync divergence: only {frac_eq:.3f} of requests agree")

    # recall of each half of the stream against its own snapshot's truth
    rec = {}
    for name, index, span in (("pre", idx0, range(0, mid)),
                              ("post", eng_async.index, range(mid, nreq))):
        hit = 0.0
        for s in cycle:
            ssel = [i for i in span if sems[i] is s]
            if not ssel:
                continue
            a = torch.as_tensor(ssel, device=dev)
            part = SearchResult(torch.as_tensor(np.stack([replies[i].ids for i in ssel])),
                                torch.as_tensor(np.stack([replies[i].dist for i in ssel])),
                                None)
            hit += recall(part, index.ground_truth(qv[a], qw[a], sem=s, k=k)) * len(ssel)
        rec[name] = hit / len(span)

    ratio = qps_async / qps_sync
    if require_qps_ratio is not None and ratio < require_qps_ratio:
        raise AssertionError(f"async runtime sustains only {ratio:.2f}x the sync batched QPS "
                             f"(need >= {require_qps_ratio}x)")
    return [
        common.row(
            "serve_sync_batched", 1e6 * dt_sync / nreq,
            f"qps={qps_sync:.0f} batch={batch} nreq={nreq} churn={b_churn}",
            qps=qps_sync, seconds=dt_sync, batch=batch, nreq=nreq, churn=b_churn,
            passes=len(t_sync)),
        common.row(
            "serve_async_runtime", 1e6 * dt_async / nreq,
            f"qps={qps_async:.0f} qps_ratio={ratio:.2f} "
            f"p50_ms={stats['p50_ms']:.1f} p99_ms={stats['p99_ms']:.1f} "
            f"rejected={stats['rejected']} writes={stats['writes']}",
            qps=qps_async, qps_ratio=ratio, seconds=dt_async, p50_ms=stats["p50_ms"],
            p99_ms=stats["p99_ms"], rejected=stats["rejected"], writes=stats["writes"]),
        common.row(
            "serve_consistency", 0.0,
            f"recall_vs_pinned_snapshot={frac_pinned:.3f} "
            f"recall_async_eq_sync={frac_eq:.3f} "
            f"recall_pre={rec['pre']:.3f} recall_post={rec['post']:.3f}",
            recall_vs_pinned_snapshot=frac_pinned, recall_async_eq_sync=frac_eq,
            recall_pre=rec["pre"], recall_post=rec["post"]),
    ]


# ---------------------------------------------------------------- kernels
def _kernel_inputs(nq: int, nx: int, d: int, device, seed: int = 0):
    """The reference's kernel-bench inputs, drawn on ``device``: Gaussian
    queries and corpus, sorted uniform object intervals, query windows of
    half-width 0.3."""
    g = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn(nq, d, generator=g, device=device)
    x = torch.randn(nx, d, generator=g, device=device)
    oi = torch.sort(torch.rand(nx, 2, generator=g, device=device), dim=1).values
    c = torch.rand(nq, 1, generator=g, device=device)
    qi = torch.cat([torch.clamp_min(c - 0.3, 0.0), torch.clamp_max(c + 0.3, 1.0)], dim=1)
    return q, x, oi, qi


def bench_kernels(nq: int = 64, nx: int = 4096, d: int = 128, *, device=None, data=None,
                  l2_nx: int | None = None, plain_nq: int | None = None):
    """The scan kernels and the expand-score kernel beside their plain
    versions (the reference's 64 × 4096 × 128 by default), top-10 scans.

    ``data=(q, x, obj_int, q_int)`` replaces the random inputs; the
    pairwise rows use the first ``l2_nx`` corpus rows and the plain scan
    the first ``plain_nq`` queries (both default to all).  The CUDA rows
    exist on the card only.  Times are host clocks around synchronized
    calls, median of three."""
    dev = resolve_device(device)
    no_tf32()
    q, x, oi, qi = _kernel_inputs(nq, nx, d, dev) if data is None else data
    nq, nx, d = q.shape[0], x.shape[0], q.shape[1]
    x_l2 = x[: l2_nx or nx]
    qp = q[: plain_nq or nq]
    on_card = dev.type == "cuda"
    rows = []

    def add(name, fn, nq_run, nx_run, what):
        dt, _ = common.timed(fn, device=dev)
        shape = f"{nq_run}x{nx_run}x{d}"
        rows.append(common.row(name, dt * 1e6, f"{what} {shape}", seconds=dt, nq=nq_run,
                               nx=nx_run, d=d))

    add("kernel_l2dist_torch_plain", lambda: ops.pairwise_sq_dist(q, x_l2, backend="torch"),
        nq, x_l2.shape[0], "plain version")
    if on_card:
        add("kernel_l2dist_cuda", lambda: ops.pairwise_sq_dist(q, x_l2, backend="cuda"),
            nq, x_l2.shape[0], "CUDA kernel")
    scan = dict(is_filter=True, k=10)
    add("kernel_fusedscan_torch_plain",
        lambda: ops.filtered_topk(qp, x, oi, qi[: qp.shape[0]], backend="torch", **scan),
        qp.shape[0], nx, "plain version")
    if on_card:
        add("kernel_fusedscan_cuda",
            lambda: ops.filtered_topk(q, x, oi, qi, backend="cuda", **scan), nq, nx,
            "CUDA kernel")
    g = torch.Generator(device=dev).manual_seed(1)
    idx = torch.randint(0, nx, (nq, 32), generator=g, device=dev, dtype=torch.int32)
    if on_card:
        add("kernel_gatherdist_cuda", lambda: ops.gather_sq_dist(x, idx, q, backend="cuda"),
            nq, 32, "CUDA kernel (expand_score)")
    add("kernel_expandscore_torch_plain", lambda: ops.expand_score(x, idx, q, backend="torch"),
        nq, 32, "plain version (bit-identical)")
    add("kernel_expandscore_legacy", lambda: expand_score_legacy(x, idx, q), nq, 32,
        "(B,C,d) gather + matmul baseline")
    return rows
