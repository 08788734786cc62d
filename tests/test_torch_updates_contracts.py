"""Contracts of the port's streaming updates on Gaussian data, on the CPU.

The reference's own update tests (``tests/test_updates_pipeline.py``), held
on the port: deleted ids never surface, slots are reused, deleting a whole
interval band NULL-certifies its window, tombstones route but never surface
and a later repair frees them, the entry structure never certifies a
tombstone, ``compact`` repairs deferred tombstones and keeps the answers,
and a mutated index round-trips through npz bit for bit.  Churn recall is
held against the reference's own churn recall on the same inputs (the fixed
0.02 bar against a fresh rebuild fails for the reference itself here).
Also: the update path forms no ``(·, C, C)`` tensor and no search or bridge
gather, the all-live extraction path equals the static one bit for bit, and
the store's statistics count live rows.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import Semantics as RefSem
from repro.core import UGConfig as RefConfig
from repro.core import UGIndex as RefIndex
from repro.core import recall as ref_recall
from repro_torch.core import (
    Semantics, UGConfig, UGIndex, brute_force, get_entry_batch_flags, recall, repair_deleted,
    update_memory_profile,
)
from repro_torch.core import intervals as iv

CHURN = dict(ef_spatial=24, ef_attribute=48, max_edges_if=24, max_edges_is=24, iterations=2,
             repair_width=8, exact_spatial=True, block=512)
SMALL = dict(ef_spatial=16, ef_attribute=32, max_edges_if=12, max_edges_is=12, iterations=2,
             repair_width=8, exact_spatial=True, block=256)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's shapes here are small: torch's intra-op pool would only
    contend with the other test processes and the reference's XLA threads,
    so this module runs torch on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def windows(rng, nq, half):
    c = rng.uniform(size=(nq, 1)).astype(np.float32)
    wide = np.concatenate([np.maximum(c - half, 0), np.minimum(c + half, 1)], axis=1)
    return wide.astype(np.float32), np.concatenate([c, c], axis=1)


def sem_cases(wide, point):
    return [(Semantics.IF, wide), (Semantics.IS, wide), (Semantics.RS, point),
            (Semantics.RF, wide)]


# ------------------------------------------------------------------ churn
@pytest.fixture(scope="module")
def churn():
    """800 rows, 10 % deleted with repair and 10 % inserted, in both
    packages from the same numpy inputs."""
    rng = np.random.default_rng(11)
    n, extra, d = 800, 80, 12
    x = rng.normal(size=(n + extra, d)).astype(np.float32)
    ints = np.sort(rng.uniform(size=(n + extra, 2)), axis=-1).astype(np.float32)
    dels = rng.choice(n, size=extra, replace=False).astype(np.int32)
    qv = rng.normal(size=(32, d)).astype(np.float32)
    wide, point = windows(rng, 32, 0.3)
    port = UGIndex.build(x[:n], ints[:n], UGConfig(**CHURN), device="cpu")
    p_del = port.delete(dels)
    p_mut = p_del.insert(x[n:], ints[n:])
    ref = RefIndex.build(jnp.asarray(x[:n]), jnp.asarray(ints[:n]), RefConfig(**CHURN))
    r_mut = ref.delete(jnp.asarray(dels)).insert(jnp.asarray(x[n:]), jnp.asarray(ints[n:]))
    return dict(p_del=p_del, p_mut=p_mut, r_mut=r_mut, dels=dels, qv=qv, wide=wide, point=point)


def test_churn_recall_within_reference_churn(churn):
    qv = churn["qv"]
    for sem, q in sem_cases(churn["wide"], churn["point"]):
        p = churn["p_mut"]
        r_p = recall(p.search(qv, q, sem=sem, ef=96, k=10),
                     p.ground_truth(qv, q, sem=sem, k=10))
        r = churn["r_mut"]
        rs = RefSem(sem.value)
        r_r = ref_recall(r.search(jnp.asarray(qv), jnp.asarray(q), sem=rs, ef=96, k=10),
                         r.ground_truth(jnp.asarray(qv), jnp.asarray(q), sem=rs, k=10))
        assert r_p >= r_r - 0.02, (sem, r_p, r_r)


def test_churn_never_surfaces_deleted(churn):
    dels = churn["dels"]
    for sem, q in sem_cases(churn["wide"], churn["point"]):
        ids = churn["p_del"].search(churn["qv"], q, sem=sem, ef=96, k=10).ids.numpy()
        assert not np.isin(ids[ids >= 0], dels).any(), sem
        mut = churn["p_mut"]
        ids = mut.search(churn["qv"], q, sem=sem, ef=96, k=10).ids.numpy()
        assert mut.alive.numpy()[ids[ids >= 0]].all(), sem


def test_churn_keeps_degree_budgets_and_counts_live_rows(churn):
    mut = churn["p_mut"]
    assert mut.n == 800 and mut.capacity == 800            # slots reused, no growth
    stats = mut.degree_stats()
    assert stats["max_if"] <= CHURN["max_edges_if"] and stats["max_is"] <= CHURN["max_edges_is"]
    truth = mut.ground_truth(churn["qv"], churn["wide"], sem=Semantics.IF, k=10)
    ids = truth.ids.numpy()
    assert mut.alive.numpy()[ids[ids >= 0]].all()


# ------------------------------------------------------------ small index
@pytest.fixture(scope="module")
def small():
    rng = np.random.default_rng(5)
    n, d = 300, 10
    x = rng.normal(size=(n, d)).astype(np.float32)
    ints = np.sort(rng.uniform(size=(n, 2)), axis=-1).astype(np.float32)
    return UGIndex.build(x, ints, UGConfig(**SMALL), device="cpu")


@pytest.fixture(scope="module")
def small_mutated(small):
    rng = np.random.default_rng(1)
    dels = rng.choice(small.n, size=25, replace=False).astype(np.int32)
    new_x = rng.normal(size=(10, small.x.shape[1])).astype(np.float32)
    new_iv = np.sort(rng.uniform(size=(10, 2)), axis=-1).astype(np.float32)
    return small.delete(dels).insert(new_x, new_iv)


def test_delete_then_reinsert_reuses_slot(small):
    victim = 17
    idx_d = small.delete([victim])
    assert idx_d.n == small.n - 1
    assert bool(idx_d.free[victim]) and not bool(idx_d.alive[victim])
    new_v = np.full((1, small.x.shape[1]), 0.25, np.float32)
    idx_r = idx_d.insert(new_v, np.asarray([[0.2, 0.8]], np.float32))
    assert idx_r.capacity == small.capacity and bool(idx_r.alive[victim])
    assert torch.allclose(idx_r.x[victim], torch.full_like(idx_r.x[victim], 0.25))
    hit = idx_r.search(new_v, np.asarray([[0.0, 1.0]], np.float32), sem=Semantics.IF,
                       ef=48, k=1)
    assert int(hit.ids[0, 0]) == victim


def test_delete_entire_interval_band(small):
    band = torch.tensor([0.3, 0.7])
    dels = torch.nonzero(iv.contains(band[None, :], small.intervals)).flatten()
    assert dels.numel() > 0
    idx_d = small.delete(dels)
    q = np.asarray([[0.3, 0.7]], np.float32)
    qv = np.zeros((1, small.x.shape[1]), np.float32)
    assert int((idx_d.search(qv, q, sem=Semantics.IF, ef=48, k=10).ids >= 0).sum()) == 0
    assert int((idx_d.ground_truth(qv, q, sem=Semantics.IF, k=10).ids >= 0).sum()) == 0


def test_tombstoned_entry_points(small):
    rng = np.random.default_rng(9)
    wide, _ = windows(rng, 24, 0.25)
    qi = torch.as_tensor(wide)
    flags = iv.as_sem_flags([Semantics.IF, Semantics.IS] * 12, 24)
    ent0 = get_entry_batch_flags(small.entry, qi, flags, width=4).numpy()
    victims = np.unique(ent0[ent0 >= 0])[:5].astype(np.int32)
    idx_d = small.delete(victims, repair=False)
    ent1 = get_entry_batch_flags(idx_d.entry, qi, flags, width=4).numpy()
    assert not np.isin(ent1[ent1 >= 0], victims).any()
    ivs = small.intervals.numpy()
    for i in range(24):
        for e in ent1[i][ent1[i] >= 0]:
            if int(flags[i]) == iv.FLAG_IF:
                assert wide[i, 0] <= ivs[e, 0] and ivs[e, 1] <= wide[i, 1]
            else:
                assert ivs[e, 0] <= wide[i, 0] and wide[i, 1] <= ivs[e, 1]


def test_tombstone_routes_but_never_surfaces(small):
    rng = np.random.default_rng(3)
    dels = rng.choice(small.n, size=30, replace=False).astype(np.int32)
    idx_d = small.delete(dels, repair=False)
    assert int((idx_d.graph.nbrs[dels] >= 0).sum()) > 0       # routing kept
    assert not bool(idx_d.free.any())                         # not yet reusable
    qv = rng.normal(size=(16, small.x.shape[1])).astype(np.float32)
    qi, _ = windows(rng, 16, 0.3)
    for sem in (Semantics.IF, Semantics.IS):
        res = idx_d.search(qv, qi, sem=sem, ef=64, k=10)
        ids = res.ids.numpy()
        assert not np.isin(ids[ids >= 0], dels).any()
        r = recall(res, idx_d.ground_truth(qv, qi, sem=sem, k=10))
        r0 = recall(small.search(qv, qi, sem=sem, ef=64, k=10),
                    small.ground_truth(qv, qi, sem=sem, k=10))
        assert r >= r0 - 0.1, (sem, r, r0)
    idx_r = repair_deleted(idx_d)
    assert int(idx_r.free.sum()) == dels.size
    assert int((idx_r.graph.nbrs[dels] >= 0).sum()) == 0


def same_search(a: UGIndex, b: UGIndex, nq=12):
    rng = np.random.default_rng(21)
    qv = rng.normal(size=(nq, a.x.shape[1])).astype(np.float32)
    qi, _ = windows(rng, nq, 0.3)
    for sem in (Semantics.IF, Semantics.IS):
        ra = a.search(qv, qi, sem=sem, ef=48, k=10)
        rb = b.search(qv, qi, sem=sem, ef=48, k=10)
        assert torch.equal(ra.ids, rb.ids) and torch.equal(ra.dist, rb.dist)


def test_npz_roundtrip_mutated_bitwise(small_mutated, tmp_path):
    small_mutated.save(tmp_path / "idx")
    back = UGIndex.load(tmp_path / "idx", device="cpu")
    assert back.n == small_mutated.n and back.capacity == small_mutated.capacity
    assert torch.equal(back.alive, small_mutated.alive)
    assert torch.equal(back.free, small_mutated.free)
    same_search(small_mutated, back)


def test_compact_repairs_deferred_tombstones(small):
    rng = np.random.default_rng(8)
    dels = rng.choice(small.n, size=30, replace=False).astype(np.int32)
    a = small.delete(dels, repair=True).compact()
    b = small.delete(dels, repair=False).compact()
    assert torch.equal(a.graph.nbrs, b.graph.nbrs)
    assert torch.equal(a.graph.status, b.graph.status)


def test_compact_preserves_answers(small_mutated):
    comp = small_mutated.compact()
    assert comp.alive is None and comp.capacity == small_mutated.n
    rng = np.random.default_rng(33)
    qv = rng.normal(size=(12, comp.x.shape[1])).astype(np.float32)
    qi, _ = windows(rng, 12, 0.3)
    live = small_mutated.alive.numpy()
    remap = np.full((small_mutated.capacity,), -1, np.int64)
    remap[np.flatnonzero(live)] = np.arange(live.sum())
    for sem in (Semantics.IF, Semantics.IS):
        old = small_mutated.search(qv, qi, sem=sem, ef=48, k=10).ids.numpy()
        new = comp.search(qv, qi, sem=sem, ef=48, k=10).ids.numpy()
        mapped = np.where(old >= 0, remap[np.clip(old, 0, None)], -1)
        for row_m, row_n in zip(mapped, new):
            assert set(row_m[row_m >= 0]) == set(row_n[row_n >= 0]), sem


def test_delete_ignores_pads_and_out_of_range_ids(small):
    a = small.delete([-1, 5, small.capacity, 10_000, 5], repair=False)
    assert a.n == small.n - 1 and not bool(a.alive[5])
    everything = small.delete(np.arange(small.n))
    assert everything.n == 0 and bool(everything.free.all())
    res = everything.search(np.zeros((2, small.x.shape[1]), np.float32),
                            np.asarray([[0.0, 1.0]] * 2, np.float32), sem=Semantics.IF)
    assert bool((res.ids == -1).all()) and bool(torch.isinf(res.dist).all())
    refilled = everything.insert(small.x[:4], small.intervals[:4])
    assert refilled.capacity == small.capacity and refilled.n == 4


# ------------------------------------------------------------ the pieces
def test_update_memory_profile():
    prof = update_memory_profile("torch")
    assert not prof["quadratic_cc"] and not prof["gather_bcd"] and prof["peak_bytes"] > 0
    with pytest.raises(NotImplementedError, match="queue 1 item 2"):
        update_memory_profile("legacy")


@pytest.mark.parametrize("rerank", [False, True])
def test_all_live_mask_equals_static_search(small, rerank):
    """A store with an all-live mask takes the tombstone extraction path;
    it must give the static path's result bit for bit."""
    idx = small.with_dtype("int8") if rerank else small
    cap = idx.capacity
    masked = idx.with_store(idx.store.replace(alive=torch.ones(cap, dtype=torch.bool),
                                              free=torch.zeros(cap, dtype=torch.bool)))
    rng = np.random.default_rng(4)
    qv = rng.normal(size=(16, idx.x.shape[1])).astype(np.float32)
    wide, point = windows(rng, 16, 0.3)
    for sem, q in sem_cases(wide, point):
        for width in (1, 4):
            a = idx.search(qv, q, sem=sem, ef=32, k=10, width=width)
            b = masked.search(qv, q, sem=sem, ef=32, k=10, width=width)
            assert torch.equal(a.ids, b.ids) and torch.equal(a.dist.view(torch.int32),
                                                             b.dist.view(torch.int32))
            assert torch.equal(a.steps, b.steps) and a.iters == b.iters


def test_brute_force_alive_mask(small):
    rng = np.random.default_rng(6)
    qv = torch.as_tensor(rng.normal(size=(8, small.x.shape[1])).astype(np.float32))
    qi = torch.tensor([[0.0, 1.0]] * 8)
    alive = torch.as_tensor(rng.uniform(size=small.capacity) < 0.5)
    full = brute_force(small.x, small.intervals, qv, qi, sem=Semantics.IF, k=300)
    masked = brute_force(small.x, small.intervals, qv, qi, sem=Semantics.IF, k=10,
                         alive=alive, block=64)
    for f, m in zip(full.ids.numpy(), masked.ids.numpy()):
        assert np.array_equal(f[alive.numpy()[f]][:10], m)


def test_growth_keeps_live_statistics(small):
    rng = np.random.default_rng(12)
    add = rng.normal(size=(40, small.x.shape[1])).astype(np.float32)
    grown = small.insert(add, np.sort(rng.uniform(size=(40, 2)), axis=-1).astype(np.float32))
    assert grown.capacity == 2 * small.capacity and grown.n == small.n + 40
    mem = grown.vector_memory_bytes()
    assert mem["plane_bytes_per_vector"] == mem["plane"] / grown.n
    stats = grown.degree_stats()
    live = grown.alive.numpy()
    deg = grown.graph.degree(iv.FLAG_IF).numpy()[live]
    assert stats["mean_if"] == float(deg.mean()) and stats["max_if"] <= SMALL["max_edges_if"]
    # the old index is untouched by the insert built on it
    assert small.alive is None and small.capacity == 300 and small.entry is not None
