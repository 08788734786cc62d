"""Inserts into quantized indexes, the port against the reference, bit for
bit, on the CPU.

The port builds an index on integer vectors whose columns span exactly
[-127, 127], re-encodes it as int8 + rerank (scale 1, zero 0: the dequant
is exact) and as pq + rerank under integer codebooks (every centroid
distance exact), and saves each; the reference loads them.  Both insert the
same rows (the store grows): the scan-plane codes, the f32 rerank plane,
the graph and the masks are equal bit for bit, and a mixed batch answers
the same at frontier widths 1 and 4.  Acquisition searches the quantized
plane; pruning and offers run on the rerank plane.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import Semantics as RefSem
from repro.core import UGIndex as RefIndex
from repro_torch.core import Semantics, UGConfig, UGIndex
from repro_torch.core.store import VectorPlane

CYCLE = [Semantics.IF, Semantics.IS, Semantics.RS, Semantics.RF]
EXACT_CFG = dict(ef_spatial=12, ef_attribute=24, max_edges_if=10, max_edges_is=10,
                 iterations=2, repair_width=8, exact_spatial=True, block=128)
N, D, N_NEW, PQ_M = 300, 8, 24, 4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's shapes here are small: torch's intra-op pool would only
    contend with the other test processes and the reference's XLA threads,
    so this module runs torch on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def as_bits(a) -> np.ndarray:
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    rng = np.random.default_rng(2)
    x = rng.integers(-127, 128, (N, D)).astype(np.float32)
    x[0], x[1] = -127, 127
    ints = np.sort(rng.uniform(size=(N, 2)), axis=-1).astype(np.float32)
    port = UGIndex.build(x, ints, UGConfig(**EXACT_CFG), device="cpu")
    t = torch.as_tensor(x)
    cb = rng.integers(-127, 128, (PQ_M, 256, D // PQ_M)).astype(np.float32)
    planes = {"int8": VectorPlane.encode(t, "int8"),
              "pq": VectorPlane.encode(t, "pq", torch.as_tensor(cb))}
    new_x = rng.integers(-127, 128, (N_NEW, D)).astype(np.float32)
    new_iv = np.sort(rng.uniform(size=(N_NEW, 2)), axis=-1).astype(np.float32)
    nq = 32
    qv = rng.integers(-127, 128, (nq, D)).astype(np.float32)
    c = rng.uniform(size=(nq, 1)).astype(np.float32)
    sems = [CYCLE[i % 4] for i in rng.permutation(nq)]
    half = {Semantics.IF: 0.3, Semantics.RF: 0.3, Semantics.IS: 0.3, Semantics.RS: 0.0}
    qi = np.stack([np.concatenate([np.maximum(c[i] - half[s], 0), np.minimum(c[i] + half[s], 1)])
                   for i, s in enumerate(sems)]).astype(np.float32)
    out = {}
    for tag, plane in planes.items():
        idx = port.with_store(port.store.replace(plane=plane,
                                                 rerank=VectorPlane.encode(t, "f32")))
        path = tmp_path_factory.mktemp(f"port_{tag}")
        idx.save(path)
        out[tag] = (idx.insert(new_x, new_iv),
                    RefIndex.load(path).insert(jnp.asarray(new_x), jnp.asarray(new_iv)))
    return out, (qv, qi, sems)


@pytest.mark.parametrize("tag", ["int8", "pq"])
def test_quantized_insert_store_bitwise(case, tag):
    port, ref = case[0][tag]
    assert port.dtype == ref.dtype == tag
    p, r = port.store, ref.store
    for name in ("nbrs", "status", "intervals", "alive", "free"):
        assert np.array_equal(as_bits(getattr(p, name)), as_bits(getattr(r, name))), name
    assert np.array_equal(as_bits(p.plane.data), as_bits(r.plane.data))
    assert np.array_equal(as_bits(p.rerank.data), as_bits(r.rerank.data))
    assert port.capacity == 2 * N and port.n == N + N_NEW


@pytest.mark.parametrize("width", [1, 4])
@pytest.mark.parametrize("tag", ["int8", "pq"])
def test_quantized_insert_search_bitwise(case, tag, width):
    port, ref = case[0][tag]
    qv, qi, sems = case[1]
    got = port.search_mixed(qv, qi, sems, ef=32, k=10, width=width)
    want = ref.search_mixed(jnp.asarray(qv), jnp.asarray(qi), [RefSem(s.value) for s in sems],
                            ef=32, k=10, backend="xla", width=width)
    for a, b in ((got.ids, want.ids), (got.dist, want.dist), (got.steps, want.steps)):
        assert np.array_equal(as_bits(a), as_bits(b))
    assert got.iters == int(want.iters)
