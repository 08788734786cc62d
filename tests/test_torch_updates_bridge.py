"""Growth, ``compact`` and the npz bridge of a mutated index, the port
against the reference, bit for bit, on the CPU.

The port builds an index on integer-valued vectors (|v| ≤ 4, d = 8,
n = 300; its exact build equals the reference's, ``test_torch_index.py``)
and saves it; the reference loads it.  Both delete the same ids, insert
more rows than the delete freed (the store grows) and compact:

* the store arrays are equal bit for bit after each step;
* a mixed IF/IS/RS/RF batch gives the same ids, distances, step counts and
  iteration counts at frontier widths 1 and 4;
* a mutated index crosses the npz bridge both ways with ``alive``/``free``
  and answers the same; the reference's insert runs on a port-saved mutated
  index and gives what it gives on its own.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import Semantics as RefSem
from repro.core import UGIndex as RefIndex
from repro_torch.core import Semantics, UGConfig, UGIndex

CYCLE = [Semantics.IF, Semantics.IS, Semantics.RS, Semantics.RF]
EXACT_CFG = dict(ef_spatial=12, ef_attribute=24, max_edges_if=10, max_edges_is=10,
                 iterations=2, repair_width=8, exact_spatial=True, block=128)
N, D, N_DEL, N_GROW, N_MORE = 300, 8, 30, 40, 20


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


def queries(rng, nq=32):
    qv = rng.integers(-4, 5, (nq, D)).astype(np.float32)
    c = rng.uniform(size=(nq, 1)).astype(np.float32)
    sems = [CYCLE[i % 4] for i in rng.permutation(nq)]
    half = {Semantics.IF: 0.3, Semantics.RF: 0.3, Semantics.IS: 0.3, Semantics.RS: 0.0}
    qi = np.stack([np.concatenate([np.maximum(c[i] - half[s], 0), np.minimum(c[i] + half[s], 1)])
                   for i, s in enumerate(sems)])
    return qv, qi.astype(np.float32), sems


def search_both(port, ref, q, width):
    qv, qi, sems = q
    got = port.search_mixed(qv, qi, sems, ef=32, k=10, width=width)
    want = ref.search_mixed(jnp.asarray(qv), jnp.asarray(qi), [RefSem(s.value) for s in sems],
                            ef=32, k=10, backend="xla", width=width)
    return got, want


def assert_same_result(got, want):
    for a, b in ((got.ids, want.ids), (got.dist, want.dist), (got.steps, want.steps)):
        assert np.array_equal(as_bits(a), as_bits(b))
    assert got.iters == int(want.iters)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    rng = np.random.default_rng(1)
    x, ints = rows(rng, N)
    port = UGIndex.build(x, ints, UGConfig(**EXACT_CFG), device="cpu")
    path = tmp_path_factory.mktemp("port_index")
    port.save(path)
    ref = RefIndex.load(path)
    dels = rng.choice(N, N_DEL, replace=False).astype(np.int32)
    grow, more = rows(rng, N_GROW), rows(rng, N_MORE)
    p_grown = port.delete(dels).insert(*grow)
    r_grown = ref.delete(jnp.asarray(dels)).insert(*(jnp.asarray(a) for a in grow))
    return dict(grown=(p_grown, r_grown), compact=(p_grown.compact(), r_grown.compact()),
                dels=dels, more=more, queries=queries(rng))


@pytest.mark.parametrize("name", ["grown", "compact"])
def test_store_arrays_bitwise(case, name):
    assert_same_store(*case[name])


@pytest.mark.parametrize("width", [1, 4])
@pytest.mark.parametrize("name", ["grown", "compact"])
def test_mixed_search_bitwise(case, name, width):
    assert_same_result(*search_both(*case[name], case["queries"], width))


def test_growth_and_compact_shapes(case):
    """Growth doubles the capacity, the 30 freed slots are taken first, the
    rest go to the lowest virgin slots; compact leaves a static index of the
    live rows with the new rows in slot order."""
    grown, comp = case["grown"][0], case["compact"][0]
    dels = np.sort(case["dels"])
    assert grown.capacity == 2 * N and grown.n == N - N_DEL + N_GROW
    alive = grown.alive.numpy()
    assert alive[dels].all() and alive[N:N + N_GROW - N_DEL].all()
    assert not alive[N + N_GROW - N_DEL:].any() and grown.free.numpy()[N + N_GROW - N_DEL:].all()
    assert comp.alive is None and comp.free is None and comp.capacity == grown.n
    assert np.array_equal(comp.x.numpy(), grown.x[torch.as_tensor(np.flatnonzero(alive))].numpy())


def test_reference_loads_port_saved_mutated_index(case, tmp_path):
    port, ref_own = case["grown"]
    port.save(tmp_path)
    loaded = RefIndex.load(tmp_path)
    assert_same_store(port, loaded)
    for width in (1, 4):
        got, want = search_both(port, loaded, case["queries"], width)
        assert_same_result(got, want)


def test_port_loads_reference_saved_mutated_index(case, tmp_path):
    port_own, ref = case["grown"]
    ref.save(tmp_path)
    loaded = UGIndex.load(tmp_path, device="cpu")
    assert loaded.alive is not None and loaded.free is not None
    assert_same_store(loaded, ref)
    entry = loaded.entry.arrays()
    assert all(torch.equal(a, b) for a, b in zip(entry, port_own.entry.arrays()))
    for width in (1, 4):
        assert_same_result(*search_both(loaded, ref, case["queries"], width))


def test_reference_insert_on_port_saved_mutated_index(case, tmp_path):
    """The reference's insert takes a port-saved tombstoned, grown index and
    gives what it gives on its own; the port's insert gives the same."""
    port, ref_own = case["grown"]
    port.save(tmp_path)
    more = case["more"]
    on_saved = RefIndex.load(tmp_path).insert(*(jnp.asarray(a) for a in more))
    on_own = ref_own.insert(*(jnp.asarray(a) for a in more))
    assert_same_store(port.insert(*more), on_saved)
    assert_same_store(port.insert(*more), on_own)
