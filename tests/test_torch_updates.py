"""Streaming updates of the port against the reference, bit for bit, on the CPU.

The reference builds an index on integer-valued vectors (|v| ≤ 4, d = 8,
n = 300, every distance exact whatever the summation order) and saves it;
the port loads it.  Both packages then apply the same numpy-made deletes and
inserts, and the store arrays (``nbrs``, ``status``, ``intervals``,
``alive``, ``free``, the planes) must be equal bit for bit after:

* ``delete(repair=True)``;
* ``delete(repair=False)`` and then ``repair_deleted(repair_iters=2)``;
* an insert into the repaired slots;
* twenty new rows around one node, which all offer to the same targets and
  run their budgets out.

A mixed IF/IS/RS/RF batch on every mutated index (and on an unrepaired
tombstoned one) gives the reference's ids, distances, step counts and
iteration counts at frontier widths 1 and 4.  A padded insert with a
``valid`` mask equals the unpadded one.  The reference compiles each insert
and search shape once (seconds each on the CPU), so the scenarios here share
shapes; growth, ``compact``, a quantized plane and the npz bridge of a
mutated index are in ``tests/test_torch_updates_bridge.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import Semantics as RefSem
from repro.core import UGConfig as RefConfig
from repro.core import UGIndex as RefIndex
from repro.core.updates import repair_deleted as ref_repair_deleted
from repro_torch.core import Semantics, UGIndex, repair_deleted

CYCLE = [Semantics.IF, Semantics.IS, Semantics.RS, Semantics.RF]
EXACT_CFG = dict(ef_spatial=12, ef_attribute=24, max_edges_if=10, max_edges_is=10,
                 iterations=2, repair_width=8, exact_spatial=True, block=128)
N, D, N_DEL, N_NEW = 300, 8, 30, 20


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's shapes here are small: torch's intra-op pool would only
    contend with the other test processes and the reference's XLA threads,
    so this module runs torch on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def mixed_queries(rng, nq, d):
    """A shuffled batch cycling IF/IS/RS/RF on integer query vectors."""
    qv = rng.integers(-4, 5, (nq, d)).astype(np.float32)
    c = rng.uniform(size=(nq, 1)).astype(np.float32)
    sems = [CYCLE[i % 4] for i in rng.permutation(nq)]
    half = {Semantics.IF: 0.3, Semantics.RF: 0.3, Semantics.IS: 0.3, Semantics.RS: 0.0}
    qi = np.stack([np.concatenate([np.maximum(c[i] - half[s], 0), np.minimum(c[i] + half[s], 1)])
                   for i, s in enumerate(sems)])
    return qv, qi.astype(np.float32), sems


def as_bits(a) -> np.ndarray:
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def assert_same_store(port, ref):
    p, r = port.store, ref.store
    for name in ("nbrs", "status", "intervals", "alive", "free"):
        a, b = getattr(p, name), getattr(r, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert a.shape == b.shape and np.array_equal(as_bits(a), as_bits(b)), name
    assert np.array_equal(as_bits(p.plane.data), as_bits(r.plane.data))
    assert (p.rerank is None) == (r.rerank is None)
    if p.rerank is not None:
        assert np.array_equal(as_bits(p.rerank.data), as_bits(r.rerank.data))
    assert port.n == int(ref.n) and port.capacity == ref.capacity


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    """The reference's build and the port's load of it, the update inputs
    (numpy) and a query batch."""
    rng = np.random.default_rng(0)
    x = rng.integers(-4, 5, (N, D)).astype(np.float32)
    ints = np.sort(rng.uniform(size=(N, 2)), axis=-1).astype(np.float32)
    ref = RefIndex.build(jnp.asarray(x), jnp.asarray(ints), RefConfig(**EXACT_CFG))
    path = tmp_path_factory.mktemp("ref_index")
    ref.save(path)
    port = UGIndex.load(path, device="cpu")
    dels = rng.choice(N, N_DEL, replace=False).astype(np.int32)
    new_x = rng.integers(-4, 5, (N_NEW, D)).astype(np.float32)
    new_iv = np.sort(rng.uniform(size=(N_NEW, 2)), axis=-1).astype(np.float32)
    # twenty rows around one live node: every one of them offers to it
    t = int(np.setdiff1d(np.arange(N), dels)[0])
    crowd_x = np.repeat(x[t:t + 1], N_NEW, axis=0)
    crowd_x[np.arange(N_NEW), np.arange(N_NEW) % D] += np.where(np.arange(N_NEW) % 2, 1, -1)
    crowd_iv = np.repeat(ints[t:t + 1], N_NEW, axis=0)
    return dict(ref=ref, port=port, dels=dels, new=(new_x, new_iv), crowd=(crowd_x, crowd_iv),
                target=t, queries=mixed_queries(rng, 32, D))


@pytest.fixture(scope="module")
def scenarios(base):
    """name -> (port index, reference index) after each update path."""
    ref, port, dels = base["ref"], base["port"], base["dels"]
    jd = jnp.asarray(dels)
    new = base["new"]
    out = {"deleted": (port.delete(dels), ref.delete(jd))}
    out["tombstoned"] = (port.delete(dels, repair=False), ref.delete(jd, repair=False))
    out["deferred_repair"] = (repair_deleted(out["tombstoned"][0], repair_iters=2),
                              ref_repair_deleted(out["tombstoned"][1], repair_iters=2))
    p_del, r_del = out["deleted"]
    out["insert_reuse"] = (p_del.insert(*new), r_del.insert(*(jnp.asarray(a) for a in new)))
    stats = {}
    out["crowd"] = (p_del.insert(*base["crowd"], stats=stats),
                    r_del.insert(*(jnp.asarray(a) for a in base["crowd"])))
    base["crowd_rounds"] = stats["offer_rounds"]
    return out


NAMES = ["deleted", "deferred_repair", "insert_reuse", "crowd"]


@pytest.mark.parametrize("name", NAMES)
def test_store_arrays_bitwise(scenarios, name):
    assert_same_store(*scenarios[name])


@pytest.mark.parametrize("width", [1, 4])
@pytest.mark.parametrize("name", NAMES + ["tombstoned"])
def test_mixed_search_on_mutated_index_bitwise(base, scenarios, name, width):
    port, ref = scenarios[name]
    qv, qi, sems = base["queries"]
    want = ref.search_mixed(jnp.asarray(qv), jnp.asarray(qi), [RefSem(s.value) for s in sems],
                            ef=32, k=10, backend="xla", width=width)
    got = port.search_mixed(qv, qi, sems, ef=32, k=10, width=width)
    for a, b in ((got.ids, want.ids), (got.dist, want.dist), (got.steps, want.steps)):
        assert np.array_equal(as_bits(a), as_bits(b))
    assert got.iters == int(want.iters)


def test_update_shapes_and_slots(base, scenarios):
    """Deletes free their slots and the insert takes the lowest free ones in
    order; a delete without repair keeps the tombstones' edges and frees
    nothing."""
    dels = np.sort(base["dels"])
    p_del = scenarios["deleted"][0]
    assert p_del.n == N - N_DEL and p_del.capacity == N
    assert np.array_equal(np.flatnonzero(p_del.free.numpy()), dels)
    p_ins = scenarios["insert_reuse"][0]
    assert p_ins.capacity == N and p_ins.n == N - N_DEL + N_NEW
    assert np.array_equal(np.flatnonzero(p_ins.free.numpy()), dels[N_NEW:])
    assert np.array_equal(p_ins.x[dels[:N_NEW]].numpy(), base["new"][0])
    assert p_ins.graph.nbrs.shape[1] == EXACT_CFG["max_edges_if"] + EXACT_CFG["max_edges_is"]
    tomb = scenarios["tombstoned"][0]
    assert not bool(tomb.free.any()) and int((tomb.graph.nbrs[dels] >= 0).sum()) > 0


def test_crowded_target_runs_out_of_budget(base, scenarios):
    """All twenty new rows offer to the node they surround, one offer
    round each; its row fills up (or its IF budget runs out) and the offers
    it cannot take are dropped, as in the reference's sequential scan."""
    t = base["target"]
    assert base["crowd_rounds"] == N_NEW
    before = scenarios["deleted"][0].graph
    after = scenarios["crowd"][0].graph
    row, st = after.nbrs[t].numpy(), after.status[t].numpy()
    m_if = EXACT_CFG["max_edges_if"]
    full = (row >= 0).all() or int(((st & 1) > 0).sum()) == m_if
    assert full and int((before.nbrs[t] >= 0).sum()) < (row >= 0).sum()
    slots = np.sort(base["dels"])[:N_NEW]
    taken = np.isin(row, slots).sum()
    assert 0 < taken < N_NEW


def test_padded_insert_equals_unpadded(base, scenarios):
    """Pad rows interleaved with the batch (a ``valid`` mask, as a
    shape-bucketed serving batch carries) allocate nothing and change
    nothing: the store equals the unpadded insert's, which is the
    reference's."""
    new_x, new_iv = base["new"]
    rng = np.random.default_rng(9)
    valid = np.ones(N_NEW + 6, bool)
    valid[rng.choice(N_NEW + 6, 6, replace=False)] = False
    px = rng.integers(-4, 5, (N_NEW + 6, D)).astype(np.float32)
    piv = np.sort(rng.uniform(size=(N_NEW + 6, 2)), axis=-1).astype(np.float32)
    px[valid], piv[valid] = new_x, new_iv
    padded = scenarios["deleted"][0].insert(px, piv, valid=valid)
    assert_same_store(padded, scenarios["insert_reuse"][1])


def test_updates_leave_their_input_usable(base, scenarios):
    """Every update returns a new index and writes into copies: the loaded
    index and the deleted one still equal the reference's after all of the
    updates built on them."""
    assert_same_store(base["port"], base["ref"])
    assert_same_store(*scenarios["deleted"])
