"""Interval-aware retrieval serving (the paper's deployment), on the card.

Pipeline: an LM tower (``--arch``, reduced unless ``--no-reduced``; the
decoder family, dense and MoE, rwkv6 and zamba2 serve) embeds a corpus of
random-token documents → the UG unified index over (embedding,
validity-interval) pairs → batched queries, embedded by the same tower,
under all four semantics (IF / IS / RS / RF) against brute-force truth;
then, on request, one interleaved mixed stream (``--mixed``), a 10 % churn
through the streaming updates (``--dynamic``) and the continuous-batching
runtime with per-request deadlines and a write mid-stream (``--async``).
Tokens, intervals and windows come from seeded ``torch.Generator``s, the
tower's weights from the port's own seeded init.

Example::

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --docs 300 \\
        --queries 16 --mixed --dynamic --async
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b --device cpu \\
        --docs 300 --queries 16 --mixed
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b --no-reduced \\
        --docs 2000 --queries 64 --mixed          # on the card

The encdec tower (seamless-m4t-medium) has no token-only forward, so, as
in the reference, its run stops at the embed step with an error.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch.configs.registry import get_arch
from repro_torch.core import Semantics, UGConfig, UGIndex, recall
from repro_torch.core import intervals as iv
from repro_torch.kernels.util import no_tf32, resolve_device
from repro_torch.models import get_model
from repro_torch.serve import RuntimeConfig, ServeEngine, ServeRuntime

CYCLE = [Semantics.IF, Semantics.IS, Semantics.RS, Semantics.RF]
EMBED_BATCH = 256              # documents a tower call embeds


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _timed(fn, dev, *, warm: bool = False):
    """``(result, seconds)`` of one call of ``fn``, the card synchronised
    around it; ``warm`` runs it once first."""
    if warm:
        fn()
    _sync(dev)
    t0 = time.perf_counter()
    out = fn()
    _sync(dev)
    return out, time.perf_counter() - t0


def embed_batches(engine: ServeEngine, tokens: torch.Tensor) -> torch.Tensor:
    """``engine.embed`` over ``tokens`` in batches of :data:`EMBED_BATCH` rows."""
    return torch.cat([engine.embed(tokens[s:s + EMBED_BATCH])
                      for s in range(0, tokens.shape[0], EMBED_BATCH)])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="qwen1.5-4b")
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction, default=True,
                    help="use the reduced config (--no-reduced serves the full-size "
                         "architecture)")
    ap.add_argument("--docs", type=int, default=2000)
    ap.add_argument("--queries", type=int, default=64)
    ap.add_argument("--doc-len", type=int, default=32)
    ap.add_argument("--ef", type=int, default=64)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--backend", default=None, choices=["cuda", "torch", "legacy"],
                    help="search kernels (default: the CUDA kernels on the card, the "
                         "plain PyTorch versions on the CPU; legacy = the one-node-per-"
                         "step loop)")
    ap.add_argument("--width", type=int, default=4,
                    help="fused multi-expansion frontier width W")
    ap.add_argument("--dtype", default="f32", choices=["f32", "bf16", "int8", "pq"],
                    help="vector scan plane of the served index (int8/pq attach the "
                         "f32 rerank plane)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the plain versions)")
    ap.add_argument("--mixed", action="store_true",
                    help="also serve one interleaved IF/IS/RS/RF stream and compare it "
                         "with four per-semantics batches")
    ap.add_argument("--dynamic", action="store_true",
                    help="churn: delete 10%% of the corpus and upsert as many new "
                         "documents through the streaming updates, then re-evaluate recall")
    ap.add_argument("--async", dest="async_serve", action="store_true",
                    help="stream the mixed workload through ServeRuntime with "
                         "per-request deadlines and a write mid-stream")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    no_tf32()
    spec = get_arch(args.arch)
    cfg = spec.reduced if args.reduced else spec.config
    if cfg.family == "encdec":
        print(f"[serve] encdec tower: {cfg.name}'s decoder needs the encoder's frames; "
              f"embedding tokens alone fails as in the reference")
    model = get_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    engine = ServeEngine(model, params)
    g = torch.Generator(device=dev).manual_seed(1)

    def tokens(n: int) -> torch.Tensor:
        return torch.randint(0, cfg.vocab, (n, args.doc_len), generator=g, device=dev)

    # 1) embed the corpus with the LM tower
    doc_tokens = tokens(args.docs)
    x, dt = _timed(lambda: embed_batches(engine, doc_tokens), dev)
    print(f"[serve] {cfg.name}: embedded {args.docs} docs (d={x.shape[1]}) in {dt:.1f}s "
          f"on {dev}")

    # 2) validity intervals (the uniform interval model, §3.2) + unified index
    intervals = iv.sample_uniform_intervals(g, args.docs)
    ucfg = UGConfig(ef_spatial=32, ef_attribute=64, max_edges_if=32, max_edges_is=32,
                    iterations=3, repair_width=16, exact_spatial=args.docs <= 4096)
    idx = UGIndex.build(x, intervals, ucfg, dtype=args.dtype, device=dev)
    engine.attach_index(idx, backend=args.backend, width=args.width)
    vm = idx.vector_memory_bytes()
    print(f"[serve] UG built in {idx.build_seconds:.1f}s ({args.dtype} plane, "
          f"{vm['plane_bytes_per_vector']:.1f} B/vec); degree stats {idx.degree_stats()}")

    # 3) queries under all four semantics (one index); wide windows c ± 0.3,
    #    point windows for RS
    qv = embed_batches(engine, tokens(args.queries))
    c = torch.rand((args.queries, 1), generator=g, device=dev)
    wide = torch.cat([(c - 0.3).clamp_min(0.0), (c + 0.3).clamp_max(1.0)], dim=1)
    point = torch.cat([c, c], dim=1)
    for sem in CYCLE:
        qint = point if sem is Semantics.RS else wide
        # qv was embedded once above: the timing is the search alone
        res, dt = _timed(lambda: engine.retrieve(None, qint, sem=sem, ef=args.ef, k=args.k,
                                                 q_v=qv), dev)
        r = recall(res, idx.ground_truth(qv, qint, sem=sem, k=args.k))
        print(f"[serve] {sem.value}: recall@{args.k} {r:.3f}  QPS {args.queries / dt:,.0f}  "
              f"mean hops {float(res.steps.float().mean()):.1f}")

    sems = [CYCLE[i % 4] for i in range(args.queries)]
    is_rs = torch.tensor([s is Semantics.RS for s in sems], device=dev)
    qmix = torch.where(is_rs[:, None], point, wide)

    # 3) mixed workload: every request carries its own semantics
    if args.mixed:
        def run_mixed():
            return engine.retrieve_mixed(None, qmix, sems, ef=args.ef, k=args.k, q_v=qv)

        subsets = {s: [i for i, ss in enumerate(sems) if ss is s] for s in CYCLE}

        def run_split():
            return {s: engine.retrieve(None, qmix[sel], sem=s, ef=args.ef, k=args.k,
                                       q_v=qv[sel]) for s, sel in subsets.items()}

        res, dt_mixed = _timed(run_mixed, dev, warm=True)
        outs, dt_split = _timed(run_split, dev, warm=True)
        recs = []
        for s, sel in subsets.items():
            sel_t = torch.tensor(sel, device=dev)
            gt = idx.ground_truth(qv[sel_t], qmix[sel_t], sem=s, k=args.k)
            part = type(res)(res.ids[sel_t], res.dist[sel_t], res.steps[sel_t])
            recs.append(f"{s.value}={recall(part, gt):.3f}")
        it_split = sum(outs[s].iters for s in CYCLE)
        print(f"[serve] mixed 4-semantics stream: QPS {args.queries / dt_mixed:,.0f} vs "
              f"split-by-semantics QPS {args.queries / dt_split:,.0f} "
              f"({dt_split / dt_mixed:.2f}x wall)  sync iters {res.iters} vs {it_split} "
              f"({it_split / max(res.iters, 1):.2f}x)  recall@{args.k} {' '.join(recs)}")

    # 4) churn through the streaming updates: tombstone deletes with repair,
    #    then bucketed upserts; the same index keeps serving every semantics
    if args.dynamic:
        n_churn = max(args.docs // 10, 1)
        dead = np.random.default_rng(5).choice(args.docs, size=n_churn, replace=False)
        _, dt_del = _timed(lambda: engine.remove(dead.astype(np.int32)), dev)
        new_tokens, new_iv = tokens(n_churn), iv.sample_uniform_intervals(g, n_churn)
        _, dt_ins = _timed(lambda: engine.upsert(new_tokens, new_iv), dev)
        idx2 = engine.index
        print(f"[serve] dynamic churn: {n_churn} deletes in {dt_del:.2f}s "
              f"({n_churn / dt_del:,.0f}/s), {n_churn} upserts in {dt_ins:.2f}s "
              f"({n_churn / dt_ins:,.0f}/s); {idx2.n} live of {idx2.capacity} slots")
        for sem in (Semantics.IF, Semantics.IS):
            res = engine.retrieve(None, wide, sem=sem, ef=args.ef, k=args.k, q_v=qv)
            gt = idx2.ground_truth(qv, wide, sem=sem, k=args.k)
            print(f"[serve] {sem.value} after churn: recall@{args.k} {recall(res, gt):.3f}")

    # 5) the continuous-batching runtime: requests arrive one at a time with
    #    their own semantics and a deadline, a write lands mid-stream, and
    #    the coalescer packs them into bucket-sized micro-batches
    if args.async_serve:
        n_churn = max(args.docs // 20, 1)
        new_x = embed_batches(engine, tokens(n_churn))
        new_iv = iv.sample_uniform_intervals(g, n_churn)
        q_rows, w_rows = qv.cpu().numpy(), qmix.cpu().numpy()   # requests arrive on the host
        before = engine.index
        engine.retrieve_mixed(None, qmix[:1], sems[:1], ef=args.ef, k=args.k, q_v=qv[:1])
        with ServeRuntime(engine, RuntimeConfig(max_batch=64)) as rt:
            futs, wfut = [], None
            for i in range(args.queries):
                futs.append(rt.submit(q_rows[i], w_rows[i], sems[i], ef=args.ef, k=args.k,
                                      deadline=rt.clock() + 600.0))
                if i == args.queries // 2:                  # a write mid-stream
                    wfut = rt.submit_upsert(new_x, new_iv)
            replies = [f.result(timeout=600) for f in futs]
            s = rt.stats()
        pre = sum(1 for r in replies if r.index is before)
        print(f"[serve] async runtime: {s['completed']} served ({s['rejected']} rejected, "
              f"{wfut.result()} docs upserted mid-stream; {pre} answered pre-write "
              f"snapshot) QPS {s['qps']:,.1f}  p50 {s['p50_ms']:.1f}ms  "
              f"p99 {s['p99_ms']:.1f}ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
