"""Shared bench fixtures: a :class:`Bench` holds one configuration and the
corpus, queries and indexes made for it; plus the timing helpers, the row
format and the reference's table sizes.  The corpora are the port's
synthetic ones (``data/synthetic.py``), drawn from the CPU's generator and
moved to the device, so a configuration holds the same numbers on every
device and a baseline written on one is a fair bar on another.
"""
from __future__ import annotations

import dataclasses
import statistics
import time

import torch

from repro_torch.core import Semantics, UGConfig, UGIndex, recall
from repro_torch.core.baselines import HiPNGLite, PostFilterIndex
from repro_torch.data import CorpusConfig, make_corpus, make_queries
from repro_torch.kernels.util import resolve_device

N_DEFAULT = 4000
DIM = 24
NQ = 64
EXACT_SPATIAL_CUTOFF = 8192   # above this the n² exact candidate pass is dropped

# The reference's sizes (benchmarks/run.py): the default, --quick and --smoke.
QUICK_N, SMOKE_N = 2000, 600
BUILD_SIZES, QUICK_BUILD_SIZES, SMOKE_BUILD_SIZES = (1000, 2000, 4000), (800, 1600), (400,)
SENSITIVITY_N, QUICK_SENSITIVITY_N = 2000, 1200
SCALABILITY_SIZES, QUICK_SCALABILITY_SIZES = (1000, 2000, 4000, 8000), (500, 1000, 2000)

UG_CFG = UGConfig(
    ef_spatial=32, ef_attribute=64, max_edges_if=32, max_edges_is=32,
    iterations=3, repair_width=16, exact_spatial=True, block=1024,
)


class Bench:
    """One bench configuration (corpus size and width, query batch, device,
    build config) and the fixtures made for it, each once.

    ``cfg=None`` takes :data:`UG_CFG`, with the exact candidate pass dropped
    above :data:`EXACT_SPATIAL_CUTOFF`; the post-filter and Hi-PNG baselines
    build with the same config.  ``corpus=(x, intervals)``, ``ug`` and
    ``queries`` (workload → ``(q_v, q_int)``) hand in a corpus, a UG index
    and query batches made elsewhere for this configuration."""

    def __init__(self, n: int = N_DEFAULT, dim: int = DIM, nq: int = NQ, device=None,
                 cfg: UGConfig | None = None, *, corpus=None, ug: UGIndex | None = None,
                 queries: dict | None = None):
        self.n, self.dim, self.nq = n, dim, nq
        self.device = resolve_device(device)
        if cfg is None:
            cfg = UG_CFG if n <= EXACT_SPATIAL_CUTOFF else dataclasses.replace(
                UG_CFG, exact_spatial=False)
        self.config = cfg
        self._made = {"corpus": corpus, "ug": ug}
        for workload, batch in (queries or {}).items():
            self._made[("queries", workload)] = batch

    def _once(self, key, make):
        if self._made.get(key) is None:
            self._made[key] = make()
        return self._made[key]

    def _moved(self, tensors):
        return tuple(t.to(self.device) for t in tensors)

    def corpus(self):
        return self._once("corpus", lambda: self._moved(make_corpus(
            CorpusConfig(n=self.n, dim=self.dim, seed=0), device="cpu")))

    def queries(self, workload: str = "uniform"):
        return self._once(("queries", workload), lambda: self._moved(make_queries(
            CorpusConfig(n=self.n, dim=self.dim), self.nq, workload=workload,
            device="cpu")))

    def resized(self, n: int) -> "Bench":
        """This configuration at ``n`` rows (itself where ``n`` is its own),
        with the default build config for that size."""
        return self if n == self.n else Bench(n, self.dim, self.nq, self.device)

    def ug_index(self) -> UGIndex:
        return self._once("ug", lambda: UGIndex.build(
            *self.corpus(), self.config, device=self.device))

    def postfilter_index(self) -> PostFilterIndex:
        return self._once("postfilter", lambda: PostFilterIndex.build(
            *self.corpus(), self.config, device=self.device))

    def hipng_index(self) -> HiPNGLite:
        return self._once("hipng", lambda: HiPNGLite.build(
            *self.corpus(), depth=2, config=self.config, device=self.device))


def synchronize(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


TIMED_CALLS = (1, 3)   # warm-up calls, timed calls


def timed(fn, *, device, calls=None):
    """``(median seconds a call, last result)`` over the timed calls after
    the warm-up ones (``calls``, default :data:`TIMED_CALLS`), each call
    ended by a synchronize on ``device`` (a host clock without one would
    time the enqueue)."""
    warmup, iters = calls or TIMED_CALLS
    out = None
    for _ in range(warmup):
        out = fn()
        synchronize(device)
    seconds = []
    for _ in range(iters):
        t0 = time.perf_counter()
        out = fn()
        synchronize(device)
        seconds.append(time.perf_counter() - t0)
    return statistics.median(seconds), out


def qps_recall(index, qv, qi, *, sem=Semantics.IF, ef=64, k=10, truth=None):
    """``(qps, recall@k)`` for one index and ef point; ``truth`` defaults to
    the index's exact ``ground_truth``."""
    dt, res = timed(lambda: index.search(qv, qi, sem=sem, ef=ef, k=k), device=qv.device)
    if truth is None:
        truth = index.ground_truth(qv, qi, sem=sem, k=k)
    return qv.shape[0] / dt, recall(res, truth)


def row(name: str, us_per_call: float, derived: str, **metrics) -> dict:
    """One table row: the reference's three columns, plus the unrounded
    numbers behind ``derived``."""
    return {"name": name, "us_per_call": us_per_call, "derived": derived, "metrics": metrics}
