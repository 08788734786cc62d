#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one card and check it.

    python3 chip_smoke.py            # from the root of a checkout, one card

Phases (each prints one JSON object per line; any failed check raises and
the script exits non-zero without printing a result):

0. the card: name and power limit, TF32 off;
1. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (nvcc, one
   process per source) and print their ``-Xptxas -v`` report;
2. each kernel at the main path's shapes, held bitwise against its plain
   PyTorch version and timed with CUDA events beside its plain version, its
   bound and, where one exists, a single PyTorch call that computes the
   same function;
3. the main path at full size: ``make_corpus`` (n = 1,000,000, d = 128,
   SIFT1M's size and width) → ``UGIndex.build`` with the build CLI's
   defaults → ``UGIndex.search_mixed`` over 10,000 queries cycling
   IF/IS/RS/RF at ef = 64, k = 10, W = 4, timed over several batches;
   recall@10 against the port's exact ``brute_force``, for those queries
   (``make_queries`` draws their cluster centres apart from the corpus's, as
   the reference does) at ef = 64 and at wider beams, and for queries drawn
   around corpus rows;
4. path checks: every kernel launched during phase 3; the kernel path equals
   the plain path bitwise for search and for a 50,000-row build; a mixed
   batch equals four per-semantics batches; recall tripwires (a broken
   graph or kernel gives ~0): mean recall@10 ≥ 0.2 over the four semantics
   on the 50,000-row index, where this synthetic workload still allows it,
   and ≥ 0.02 on the 1M index (chance is ~1e-5 there); the 50,000-row
   index's recall beside that of an exact-KNN (``exact_spatial``) build of
   the same corpus.

The last line is ``{"ok": true, "device": {...}}``.  Nothing here imports
JAX or the reference package.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
N_MAIN = 1_000_000             # corpus rows of the main path (SIFT1M's size)
N_CHECK = 50_000               # corpus rows of the build-parity check
N_QUERIES = 10_000
PER_SEM = 1_000                # queries per semantics that recall is scored on
SEARCH = dict(ef=64, k=10, width=4)
WIDE_EFS = (128, 256, 1024)    # wider beams over the same queries
TIMED_BATCHES = 5
PEAK_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
PEAK_FP32_PER_S = 67e12        # H100 SXM fp32 outside the tensor cores
KERNELS = {
    "expand_score": ("src/repro_torch/kernels/csrc/expand_score.cu",
                     "src/repro/kernels/expand_score.py:63"),
    "beam_merge": ("src/repro_torch/kernels/csrc/beam_merge.cu",
                   "src/repro/kernels/beam_merge.py:132"),
    "prune_sweep": ("src/repro_torch/kernels/csrc/prune_sweep.cu",
                    "src/repro/kernels/prune_sweep.py:167"),
}


def emit(**obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def bits_equal(a, b) -> bool:
    import torch

    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return bool(torch.equal(a, b))


def max_abs_err(a, b) -> float:
    import torch

    a, b = a.double(), b.double()
    diff = torch.where(a == b, torch.zeros_like(a), (a - b).abs())
    return float(diff.max()) if diff.numel() else 0.0


def cuda_ms(fn, reps: int = 20, warm: int = 3) -> float:
    """Mean milliseconds per call over ``reps`` back-to-back calls."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FP32_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ----------------------------------------------------------------- phases
def phase0_card():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    from repro_torch.kernels.util import no_tf32

    no_tf32()
    emit(phase=0, card=smi, torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0), count=torch.cuda.device_count())
    return smi


def phase1_build():
    from repro_torch.kernels import cuda_lib

    t0 = time.perf_counter()
    cuda_lib.lib()
    info = cuda_lib.build_info
    ptxas = [ln.strip() for ln in info.get("log", "").splitlines()
             if "Compiling entry" in ln or "Used" in ln or "spill" in ln]
    emit(phase=1, build_seconds=info.get("seconds", 0.0), cached=info.get("cached"),
         load_seconds=time.perf_counter() - t0, ptxas=ptxas)


def phase2_kernels(dev) -> dict:
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.beam_merge import PAD_PAYLOAD

    rows = {}
    g = torch.Generator(device=dev).manual_seed(1234)

    # expand_score: n = 1M, d = 128, B = 10,000, C = 256, 20 % masked
    n, d, B, C = 1_000_000, 128, 10_000, 256
    x = torch.randn(n, d, generator=g, device=dev)
    q = torch.randn(B, d, generator=g, device=dev)
    idx = torch.randint(0, n, (B, C), generator=g, device=dev, dtype=torch.int32)
    idx = torch.where(torch.rand(B, C, generator=g, device=dev) < 0.2, -1, idx).contiguous()
    got = ops.expand_score(x, idx, q, backend="cuda")
    want = ops.expand_score(x, idx, q, backend="torch")
    torch.cuda.synchronize()
    check(bits_equal(got, want), "expand_score kernel != plain version")
    n_valid = int((idx >= 0).sum())
    b_ms, b_by = bound(n_valid * 4 * d + B * C * 8 + B * d * 4, n_valid * 3 * d)
    rows["expand_score"] = dict(
        ms=cuda_ms(lambda: ops.expand_score(x, idx, q, backend="cuda")),
        plain_ms=cuda_ms(lambda: ops.expand_score(x, idx, q, backend="torch"), reps=5),
        library_ms=None, bound_ms=b_ms, bound_by=b_by, max_abs_err=max_abs_err(got, want),
        shape=dict(n=n, d=d, B=B, C=C, masked=B * C - n_valid))
    del x, q, idx, got, want

    # beam_merge: B = 10,000, E = 64, L = 256, with ties, +inf and pads
    B, E, L = 10_000, 64, 256
    pool = torch.tensor([0.25, 0.5, 1.0, 2.0, float("inf")], device=dev)
    bd = pool[torch.randint(0, 5, (B, E), generator=g, device=dev)]
    bp = torch.randint(0, 500_000, (B, E), generator=g, device=dev, dtype=torch.int32) << 1
    bp = torch.where(torch.isfinite(bd), bp, PAD_PAYLOAD)
    bd, o = torch.sort(bd, dim=-1, stable=True)
    bp = torch.gather(bp, -1, o).contiguous()
    bd = bd.contiguous()
    cd = pool[torch.randint(0, 5, (B, L), generator=g, device=dev)].contiguous()
    cp = (torch.randint(0, 500_000, (B, L), generator=g, device=dev, dtype=torch.int32) << 1)
    cp = torch.where(torch.isfinite(cd), cp, PAD_PAYLOAD).contiguous()
    got = ops.beam_merge(bd, bp, cd, cp, backend="cuda")
    want = ops.beam_merge(bd, bp, cd, cp, backend="torch")
    torch.cuda.synchronize()
    check(all(bits_equal(a, b) for a, b in zip(got, want)), "beam_merge kernel != plain version")
    cat_d = torch.cat([bd, cd], dim=1)
    lg = int(np.log2(L))
    ce_per_row = L // 2 * lg * (lg + 1) // 2 + E + E // 2 * int(np.log2(E))
    b_ms, b_by = bound(B * (2 * E + 2 * L) * 4 + B * 2 * E * 4, B * ce_per_row * 2)
    rows["beam_merge"] = dict(
        ms=cuda_ms(lambda: ops.beam_merge(bd, bp, cd, cp, backend="cuda")),
        plain_ms=cuda_ms(lambda: ops.beam_merge(bd, bp, cd, cp, backend="torch"), reps=5),
        library_ms=cuda_ms(lambda: torch.topk(cat_d, E, dim=1, largest=False, sorted=True)),
        bound_ms=b_ms, bound_by=b_by,
        max_abs_err=max(max_abs_err(a, b) for a, b in zip(got, want)),
        shape=dict(B=B, E=E, L=L))
    del bd, bp, cd, cp, cat_d, got, want

    # prune_sweep: B = 1024, C = 96, d = 128, point intervals, all-pad rows
    B, C, d = 1024, 96, 128
    xs = torch.randn(B, C, d, generator=g, device=dev)
    i_c = torch.sort(torch.rand(B, C, 2, generator=g, device=dev), dim=-1).values
    i_c[::7, :, 1] = i_c[::7, :, 0]                         # point intervals
    i_u = torch.sort(torch.rand(B, 2, generator=g, device=dev), dim=-1).values
    i_u[::13, 1] = i_u[::13, 0]
    d_uc = torch.sort(torch.rand(B, C, generator=g, device=dev) * 2 * d, dim=-1).values
    valid = torch.rand(B, C, generator=g, device=dev) >= 0.1
    valid[::50] = False                                     # all-pad rows
    d_uc = torch.where(valid, d_uc, torch.inf)
    overlap = (torch.maximum(i_u[:, None, 0], i_c[..., 0])
               <= torch.minimum(i_u[:, None, 1], i_c[..., 1]))
    args = [t.contiguous() for t in (i_u, xs, i_c, d_uc, valid.int(), overlap.int())]
    kw = dict(m_if=32, m_is=32, alpha=1.0, unified=True)
    got = ops.prune_sweep(*args, backend="cuda", **kw)
    want = ops.prune_sweep(*args, backend="torch", **kw)
    torch.cuda.synchronize()
    check(all(bits_equal(a, b) for a, b in zip(got, want)), "prune_sweep kernel != plain version")
    # the pairs (t, w) the scan needs: valid t against retained w < t
    kept = (got[0] > 0).int()
    before = torch.cumsum(kept, dim=1) - kept
    pairs = int((before * valid.int()).sum())
    b_ms, b_by = bound(B * (2 + C * d + 2 * C + C + 2 * C) * 4 + 3 * B * C * 4, pairs * 3 * d)
    rows["prune_sweep"] = dict(
        ms=cuda_ms(lambda: ops.prune_sweep(*args, backend="cuda", **kw)),
        plain_ms=cuda_ms(lambda: ops.prune_sweep(*args, backend="torch", **kw), reps=3, warm=1),
        library_ms=None, bound_ms=b_ms, bound_by=b_by,
        max_abs_err=max(max_abs_err(a, b) for a, b in zip(got, want)),
        shape=dict(B=B, C=C, d=d, pairs=pairs))
    for name, r in rows.items():
        emit(kernel=name, bitwise=True, kernel_ms=r["ms"], plain_ms=r["plain_ms"],
             library_ms=r["library_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"],
             shape=r["shape"])
    return rows


def mixed_workload(ccfg, nq: int, dev):
    """10,000-style mixed batch: semantics cycling IF/IS/RS/RF; RS rows get
    point windows at the centre of their uniform window."""
    import torch

    from repro_torch.core import Semantics
    from repro_torch.data import make_queries

    cycle = [Semantics.IF, Semantics.IS, Semantics.RS, Semantics.RF]
    qv, wide = make_queries(ccfg, nq, workload="uniform", device=dev)
    _, point = make_queries(ccfg, nq, workload="point", device=dev)
    sems = [cycle[i % 4] for i in range(nq)]
    is_rs = torch.tensor([s is Semantics.RS for s in sems], device=dev)
    qi = torch.where(is_rs[:, None], point, wide)
    return qv, qi, sems


def scored_queries(idx, qv, qi, sems) -> dict:
    """The first ``PER_SEM`` queries of each semantics and their exact top 10."""
    import torch

    out = {}
    for s in sorted(set(sems), key=lambda s: s.value):
        sel = torch.tensor([i for i, ss in enumerate(sems) if ss is s][:PER_SEM], device=qv.device)
        out[s] = (sel, idx.ground_truth(qv[sel], qi[sel], sem=s, k=10))
    return out


def recall_per_semantics(res, scored) -> dict:
    """recall@10 per semantics of ``res`` over the queries of ``scored``."""
    from repro_torch.core import recall

    return {s.value: recall(subset(res, sel), truth) for s, (sel, truth) in scored.items()}


def mean(values) -> float:
    values = list(values)
    return sum(values) / len(values)


def subset(res, sel):
    from repro_torch.core import SearchResult

    return SearchResult(res.ids[sel], res.dist[sel], res.steps[sel])


def same_result(a, b) -> bool:
    return (bits_equal(a.ids, b.ids) and bits_equal(a.dist, b.dist)
            and bits_equal(a.steps, b.steps))


def phase3_main_path(dev):
    import statistics

    import torch

    from repro_torch.core import UGConfig, UGIndex
    from repro_torch.data import CorpusConfig, make_corpus
    from repro_torch.kernels import ops

    n, nq = N_MAIN, N_QUERIES
    ccfg = CorpusConfig(n=n, dim=128, seed=0)
    cfg = UGConfig(ef_spatial=32, ef_attribute=64, max_edges_if=32, max_edges_is=32,
                   iterations=3, exact_spatial=n <= 8192)
    torch.cuda.reset_peak_memory_stats()
    x, ints = make_corpus(ccfg, device=dev)
    qv, qi, sems = mixed_workload(ccfg, nq, dev)
    torch.cuda.synchronize()

    marks = {}

    def progress(msg):
        if msg.startswith("candidates"):
            torch.cuda.synchronize()
            marks["candidates"] = time.perf_counter()

    ops.reset_launches()                                   # the main path's run
    t_build = time.perf_counter()
    idx = UGIndex.build(x, ints, cfg, seed=0, device=dev, progress=progress)
    idx.search_mixed(qv, qi, sems, **SEARCH)                # warm-up
    seconds = []
    for _ in range(TIMED_BATCHES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = idx.search_mixed(qv, qi, sems, **SEARCH)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    launches = dict(ops.launches)

    scored = scored_queries(idx, qv, qi, sems)
    recalls = recall_per_semantics(res, scored)
    # the same scored queries through wider beams: recall that climbs with
    # ef says the graph leads to the true neighbours, only slowly
    sel = torch.cat([s for s, _ in scored.values()])
    pos = torch.empty(nq, dtype=torch.long, device=dev)
    pos[sel] = torch.arange(len(sel), device=dev)
    narrowed = {s: (pos[s_sel], truth) for s, (s_sel, truth) in scored.items()}
    sems_sel = [sems[i] for i in sel.tolist()]
    by_ef = {}
    for ef in WIDE_EFS:
        r = idx.search_mixed(qv[sel], qi[sel], sems_sel, ef=ef, k=10, width=4)
        by_ef[ef] = dict(recall_at_10=recall_per_semantics(r, narrowed), iters=r.iters,
                         mean_steps=float(r.steps.float().mean()))
    # queries drawn around corpus rows, with the corpus's own cluster spread
    g = torch.Generator(device=dev).manual_seed(7)
    rows = torch.randint(0, n, (nq,), generator=g, device=dev)
    qv_in = x[rows] + ccfg.cluster_std * torch.randn(nq, 128, generator=g, device=dev)
    res_in = idx.search_mixed(qv_in, qi, sems, **SEARCH)
    recalls_in = recall_per_semantics(res_in, scored_queries(idx, qv_in, qi, sems))
    mem = idx.vector_memory_bytes()
    med = statistics.median(seconds)
    emit(phase=3, n=n, d=128, queries=nq, build_seconds=idx.build_seconds,
         candidates_seconds=marks["candidates"] - t_build,
         degree_stats=idx.degree_stats(), graph_width=idx.graph.max_degree,
         graph_bytes=idx.memory_bytes(), plane_bytes=mem["plane"],
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         search_seconds=seconds, qps=nq / med, qps_min=nq / max(seconds),
         qps_max=nq / min(seconds), iters=res.iters,
         mean_steps=float(res.steps.float().mean()), recall_at_10=recalls,
         recall_at_10_wider_beams=by_ef,
         recall_at_10_corpus_queries=recalls_in, iters_corpus_queries=res_in.iters,
         launches=launches)
    return idx, (qv, qi, sems), recalls, launches


def phase4_checks(dev, idx, queries, recalls, launches):
    import torch

    from repro_torch.core import UGConfig, UGIndex
    from repro_torch.data import CorpusConfig, make_corpus

    qv, qi, sems = queries
    out = {}
    # (a) every kernel ran on the main path
    for name in KERNELS:
        check(launches.get(name, 0) > 0, f"{name} was not launched on the main path")
    out["a_launches"] = launches

    # (b) kernel path == plain path, 1,000 queries
    sub = slice(0, 1000)
    r_cuda = idx.search_mixed(qv[sub], qi[sub], sems[sub], backend="cuda", **SEARCH)
    r_torch = idx.search_mixed(qv[sub], qi[sub], sems[sub], backend="torch", **SEARCH)
    check(same_result(r_cuda, r_torch) and r_cuda.iters == r_torch.iters,
          "search: backend='cuda' != backend='torch'")
    out["b_search_bitwise"] = True

    # (c) the mixed batch equals four per-semantics batches
    for s in set(sems[sub]):
        sel = [i for i, ss in enumerate(sems[sub]) if ss is s]
        one = idx.search(qv[sel], qi[sel], sem=s, **SEARCH)
        check(same_result(subset(r_cuda, torch.tensor(sel, device=dev)), one),
              f"mixed batch != per-semantics batch for {s.value}")
    out["c_mixed_equals_per_semantics"] = True

    # (d) a 50,000-row build: prune_backend cuda == torch
    ccfg = CorpusConfig(n=N_CHECK, dim=128, seed=1)
    x, ints = make_corpus(ccfg, device=dev)
    base = dict(ef_spatial=32, ef_attribute=64, max_edges_if=32, max_edges_is=32, iterations=3)
    idx50 = UGIndex.build(x, ints, UGConfig(**base, prune_backend="cuda"), device=dev)
    g_torch = UGIndex.build(x, ints, UGConfig(**base, prune_backend="torch"), device=dev).graph
    check(bits_equal(idx50.graph.nbrs, g_torch.nbrs)
          and bits_equal(idx50.graph.status, g_torch.status),
          "build: prune_backend='cuda' != 'torch'")
    out["d_build_bitwise"] = True

    # (e) tripwires: a broken graph or kernel gives recall near 0.  The
    # workload's query centres lie apart from the corpus's, and recall at
    # ef = 64 falls with n, so the 0.2 bar is held at 50,000 rows.  Beside
    # it, an exact-KNN build of the same corpus: NN-descent's share of the
    # recall lost.
    qv50, qi50, sems50 = mixed_workload(ccfg, 4 * PER_SEM, dev)
    scored50 = scored_queries(idx50, qv50, qi50, sems50)
    recalls50 = recall_per_semantics(idx50.search_mixed(qv50, qi50, sems50, **SEARCH), scored50)
    exact50 = UGIndex.build(x, ints, UGConfig(**base, exact_spatial=True), device=dev)
    recalls_exact = recall_per_semantics(
        exact50.search_mixed(qv50, qi50, sems50, **SEARCH), scored50)
    out["e_recall_at_10_50k"] = recalls50
    out["e_recall_at_10_50k_exact_spatial"] = recalls_exact
    out["e_degree_stats_50k"] = idx50.degree_stats()
    out["e_degree_stats_50k_exact_spatial"] = exact50.degree_stats()
    out["e_mean_recall_50k"] = mean50 = mean(recalls50.values())
    out["e_mean_recall_50k_exact_spatial"] = mean(recalls_exact.values())
    out["e_mean_recall_main"] = mean_main = mean(recalls.values())
    check(mean50 >= 0.2, f"mean recall@10 {mean50} < 0.2 at n = {N_CHECK}")
    check(mean_main >= 0.02, f"mean recall@10 {mean_main} < 0.02 on the main path")
    emit(phase=4, **out)


def main() -> int:
    t_start = time.perf_counter()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is available")
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)

    smi = phase0_card()
    dev = torch.device("cuda")
    phase1_build()
    rows = phase2_kernels(dev)
    idx, queries, recalls, launches = phase3_main_path(dev)
    phase4_checks(dev, idx, queries, recalls, launches)

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        r = rows[name]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches[name], bitwise=True, max_abs_err=r["max_abs_err"],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"]))
    emit(seconds=time.perf_counter() - t_start, card=smi)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
