"""The port's ``ServeEngine`` against the reference's, bit for bit, on the
CPU: the same index (integer-valued vectors, |v| ≤ 4, d = 8, n = 300; the
port builds and saves it, the reference loads it), then on both engines an
upsert of 5 rows (padded to the bucket of 8), a remove of 3 ids (padded
with -1 ids) and a mixed IF/IS/RS/RF ``retrieve_mixed`` (padded to its
bucket):

* the stores are equal bit for bit after each write;
* the answers (ids, distances, steps, iterations) are equal bit for bit;
* the reference's own engine contract holds on the port
  (``test_engine_upsert_remove_bucketing``): live counts, no removed id
  surfaces, the capacity holds the padded batch.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import Semantics as RefSem
from repro.core import UGIndex as RefIndex
from repro.serve.engine import ServeEngine as RefEngine
from repro_torch.core import Semantics, UGConfig, UGIndex
from repro_torch.serve import ServeEngine

CYCLE = [Semantics.IF, Semantics.IS, Semantics.RS, Semantics.RF]
EXACT_CFG = dict(ef_spatial=12, ef_attribute=24, max_edges_if=10, max_edges_is=10,
                 iterations=2, repair_width=8, exact_spatial=True, block=128)
N, D = 300, 8


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small shapes: torch's intra-op pool would only contend with the other
    test processes and the reference's XLA threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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
    assert port.n == int(ref.n) and port.capacity == ref.capacity


def rows(rng, n):
    x = rng.integers(-4, 5, (n, D)).astype(np.float32)
    return x, np.sort(rng.uniform(size=(n, 2)), axis=-1).astype(np.float32)


def ref_engine(index):
    """The reference's engine without an LM tower, as its own
    ``test_engine_upsert_remove_bucketing`` makes it."""
    engine = RefEngine.__new__(RefEngine)
    engine.index = None
    engine.search_backend = "xla"
    engine.search_width = 4
    engine.attach_index(index)
    return engine


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    rng = np.random.default_rng(3)
    x, ints = rows(rng, N)
    port = UGIndex.build(x, ints, UGConfig(**EXACT_CFG), device="cpu")
    path = tmp_path_factory.mktemp("serve_bridge")
    port.save(path)
    ref = RefIndex.load(path)
    new = rows(rng, 5)
    dels = np.array([0, 1, 2], np.int32)
    nq = 24
    qv = rng.integers(-4, 5, (nq, D)).astype(np.float32)
    c = rng.uniform(size=(nq, 1)).astype(np.float32)
    sems = [CYCLE[i % 4] for i in rng.permutation(nq)]
    half = np.array([[0.0 if s is Semantics.RS else 0.3] for s in sems], np.float32)
    qi = np.concatenate([np.maximum(c - half, 0), np.minimum(c + half, 1)], 1)
    # the first queries sit on the removed rows, IF over the whole line
    qv[:3], qi[:3], sems[:3] = x[dels], [0.0, 1.0], [Semantics.IF] * 3

    p_eng, r_eng = ServeEngine(), ref_engine(ref)
    p_eng.attach_index(port)
    out = dict(n0=port.n, dels=dels, new=new)
    p_eng.upsert(None, new[1], x=new[0])
    r_eng.upsert(None, jnp.asarray(new[1]), x=jnp.asarray(new[0]))
    out["upsert"] = (p_eng.index, r_eng.index)
    p_eng.remove(dels)
    r_eng.remove(jnp.asarray(dels))
    out["remove"] = (p_eng.index, r_eng.index)
    out["mixed"] = (p_eng.retrieve_mixed(None, qi, sems, ef=32, k=10, q_v=qv),
                    r_eng.retrieve_mixed(None, jnp.asarray(qi), [RefSem(s.value) for s in sems],
                                         ef=32, k=10, q_v=jnp.asarray(qv)))
    return out


@pytest.mark.parametrize("step", ["upsert", "remove"])
def test_stores_bitwise_after_each_write(case, step):
    assert_same_store(*case[step])


def test_answers_bitwise(case):
    got, want = case["mixed"]
    for a, b in ((got.ids, want.ids), (got.dist, want.dist), (got.steps, want.steps)):
        assert a.shape == b.shape and np.array_equal(as_bits(a), as_bits(b))
    assert got.iters == int(want.iters)


def test_engine_upsert_remove_bucketing(case):
    """The reference's engine contract, on the port: pad rows allocate
    nothing, removed ids never surface, the capacity holds the bucket."""
    after_upsert, _ = case["upsert"]
    after_remove, _ = case["remove"]
    assert after_upsert.n == case["n0"] + 5
    assert after_remove.n == case["n0"] + 5 - 3
    ids = case["mixed"][0].ids.numpy()
    assert not np.isin(ids[ids >= 0], case["dels"]).any()
    assert after_remove.capacity >= case["n0"] + 8
    assert not after_remove.alive[torch.as_tensor(case["dels"]).long()].any()
