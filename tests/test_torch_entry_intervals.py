"""The pieces of the port's core modules that streaming updates and the
sharded and legacy paths build on, against the reference, on the CPU.

* ``phi_if``/``phi_is``/``query_valid_mask_by_flag`` bitwise on every triple
  of grid intervals, points and inverted (empty) ones included;
* ``get_entry_flags``/``get_entry``/``get_entry_batch`` bitwise on intervals
  with repeated endpoints, with and without a ``node_mask``;
* the two cost counters (``candidate_pool_width``,
  ``merge_comparator_count``) equal over a grid;
* the store's allocator (``masks``/``widen_rows``/``grow``) gives the
  reference's arrays on every plane;
* the interval samplers draw from the port's own generator: their shape,
  dtype, order and range are held, not the reference's numbers.

Grid endpoints keep subnormals out (XLA on the CPU flushes them to zero).
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import entry as ref_entry
from repro.core import intervals as ref_iv
from repro.core import store as ref_store
from repro.core.candidates import candidate_pool_width as ref_pool_width
from repro.kernels.beam_merge import merge_comparator_count as ref_merge_count
from repro_torch.core import entry as port_entry
from repro_torch.core import intervals as port_iv
from repro_torch.core import store as port_store
from repro_torch.core.candidates import candidate_pool_width
from repro_torch.kernels.beam_merge import merge_comparator_count

GRID = [0.0, 0.25, 0.5, 0.75, 1.0]
PAIRS = np.asarray(list(itertools.product(GRID, GRID)), np.float32)     # (25, 2)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's shapes here are small: torch's intra-op pool would only
    contend with the other test processes and the reference's XLA threads,
    so this module runs torch on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_phi_conditions_match_on_grid_triples():
    trip = np.asarray(list(itertools.product(range(len(PAIRS)), repeat=3)))
    u, v, w = (PAIRS[trip[:, i]] for i in range(3))
    for fn in ("phi_if", "phi_is"):
        got = getattr(port_iv, fn)(*(torch.as_tensor(a) for a in (u, v, w))).numpy()
        want = np.asarray(getattr(ref_iv, fn)(*(jnp.asarray(a) for a in (u, v, w))))
        assert got.dtype == np.bool_ and np.array_equal(got, want), fn
    # both outcomes occur, and an empty intersection never witnesses IS
    assert port_iv.phi_is(torch.tensor([0.0, 0.25]), torch.tensor([0.5, 1.0]),
                          torch.tensor([0.0, 1.0])).item() is False


def test_query_valid_mask_by_flag_matches():
    rng = np.random.default_rng(3)
    objs = PAIRS
    q = PAIRS[rng.integers(0, len(PAIRS), 40)]
    flags = rng.choice([port_iv.FLAG_IF, port_iv.FLAG_IS], 40).astype(np.int32)
    got = port_iv.query_valid_mask_by_flag(torch.as_tensor(flags), torch.as_tensor(objs),
                                           torch.as_tensor(q))
    want = ref_iv.query_valid_mask_by_flag(jnp.asarray(flags), jnp.asarray(objs), jnp.asarray(q))
    assert tuple(got.shape) == (40, len(objs))
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("sampler", ["sample_uniform_intervals", "sample_point_intervals"])
def test_interval_samplers(sampler):
    fn = getattr(port_iv, sampler)
    a = fn(torch.Generator().manual_seed(5), 1000)
    b = fn(torch.Generator().manual_seed(5), 1000)
    assert a.shape == (1000, 2) and a.dtype == torch.float32
    assert torch.equal(a, b)                       # the seed fixes the draw
    assert bool((a[:, 0] <= a[:, 1]).all()) and bool(((a >= 0) & (a < 1)).all())
    if sampler == "sample_point_intervals":
        assert torch.equal(a[:, 0], a[:, 1])
    else:
        assert bool((a[:, 0] < a[:, 1]).any())
    assert fn(torch.Generator().manual_seed(5), 7, torch.float64).dtype == torch.float64


# ------------------------------------------------------------------ entry
@pytest.fixture(scope="module")
def entry_case():
    """Intervals with repeated endpoints (grid), a node mask, and queries
    over every grid pair (points and inverted windows included)."""
    rng = np.random.default_rng(11)
    ints = np.sort(rng.choice(GRID, size=(60, 2)), axis=-1).astype(np.float32)
    mask = rng.uniform(size=60) < 0.6
    q = np.concatenate([PAIRS, PAIRS[rng.integers(0, len(PAIRS), 15)]])
    flags = rng.choice([port_iv.FLAG_IF, port_iv.FLAG_IS], len(q)).astype(np.int32)
    return ints, mask, q, flags


def both_entries(ints, mask):
    port = port_entry.build_entry_index(
        torch.as_tensor(ints), None if mask is None else torch.as_tensor(mask))
    ref = ref_entry.build_entry_index(
        jnp.asarray(ints), None if mask is None else jnp.asarray(mask))
    return port, ref


@pytest.mark.parametrize("masked", [False, True])
def test_get_entry_flags_and_get_entry_match(entry_case, masked):
    ints, mask, q, flags = entry_case
    port, ref = both_entries(ints, mask if masked else None)
    got = port_entry.get_entry_flags(port, torch.as_tensor(q), torch.as_tensor(flags))
    want = ref_entry.get_entry_flags(ref, jnp.asarray(q), jnp.asarray(flags))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), np.asarray(want))
    for s in port_iv.Semantics:
        got = port_entry.get_entry(port, torch.as_tensor(q), s)
        want = ref_entry.get_entry(ref, jnp.asarray(q), ref_iv.Semantics(s.value))
        assert got.dtype == torch.int32 and np.array_equal(got.numpy(), np.asarray(want)), s
    if masked:        # a certified entry is never a masked node
        ids = got.numpy()
        assert mask[ids[ids >= 0]].all()


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("width", [1, 3, 5])
def test_get_entry_batch_matches(entry_case, masked, width):
    ints, mask, q, _ = entry_case
    port, ref = both_entries(ints, mask if masked else None)
    for s in port_iv.Semantics:
        got = port_entry.get_entry_batch(port, torch.as_tensor(q), s, width=width)
        want = ref_entry.get_entry_batch(ref, jnp.asarray(q), ref_iv.Semantics(s.value),
                                         width=width)
        assert tuple(got.shape) == (len(q), width)
        assert np.array_equal(got.numpy(), np.asarray(want)), s
        assert np.array_equal(got[:, 0].numpy(),
                              port_entry.get_entry(port, torch.as_tensor(q), s).numpy())


# --------------------------------------------------------------- counters
def test_cost_counters_match():
    for ef_s, ef_a in itertools.product([1, 8, 32, 128], [1, 7, 8, 64, 300]):
        assert candidate_pool_width(ef_s, ef_a) == ref_pool_width(ef_s, ef_a)
    for ef, M, width, fused in itertools.product([1, 10, 32, 64, 100], [1, 8, 32, 256],
                                                 [1, 2, 4, 8], [True, False]):
        assert merge_comparator_count(ef, M, width=width, fused=fused) == ref_merge_count(
            ef, M, width=width, fused=fused)


# --------------------------------------------------------------- allocator
def store_pair(tag: str, *, masks: bool):
    """The same arrays as a port store and a reference store on plane
    ``tag`` (pq with integer codebooks, so the codes are exact); with
    ``masks`` a third of the rows tombstoned and some of those free."""
    rng = np.random.default_rng(2)
    n, d, M = 40, 8, 5
    x = rng.integers(-9, 10, (n, d)).astype(np.float32)
    ints = np.sort(rng.uniform(size=(n, 2)), axis=-1).astype(np.float32)
    nbrs = rng.integers(-1, n, (n, M)).astype(np.int32)
    status = rng.integers(0, 4, (n, M)).astype(np.uint8)
    qp = rng.integers(-9, 10, (2, 256, 4)).astype(np.float32) if tag == "pq" else None
    alive = free = None
    if masks:
        alive = rng.uniform(size=n) < 0.66
        free = ~alive & (rng.uniform(size=n) < 0.5)
    port = port_store.make_store(x, ints, nbrs, status, dtype="f32", rerank=tag != "f32",
                                 device="cpu")
    port = port.replace(plane=port_store.VectorPlane.encode(
        torch.as_tensor(x), tag, None if qp is None else torch.as_tensor(qp)))
    if masks:
        port = port.replace(alive=torch.as_tensor(alive), free=torch.as_tensor(free))
    ref = ref_store.make_store(
        jnp.asarray(x), jnp.asarray(ints), jnp.asarray(nbrs), jnp.asarray(status), dtype=tag,
        rerank=tag != "f32", qparams=None if qp is None else jnp.asarray(qp),
        alive=None if alive is None else jnp.asarray(alive),
        free=None if free is None else jnp.asarray(free))
    return port, ref


def as_bits(a) -> np.ndarray:
    """Bit patterns of a tensor or array: floats as integers of their width."""
    if isinstance(a, torch.Tensor):
        a = (a.view(torch.int16) if a.dtype == torch.bfloat16 else a).numpy()
    a = np.asarray(a)
    if a.dtype.kind not in "biu":
        a = a.view({2: np.int16, 4: np.int32}[a.dtype.itemsize])
    return a


def assert_store_arrays_equal(port, ref):
    def eq(a, b):
        if a is None or b is None:
            return a is None and b is None
        a, b = as_bits(a), as_bits(b)
        return a.shape == b.shape and np.array_equal(a, b)

    assert eq(port.intervals, ref.intervals)
    assert eq(port.nbrs, ref.nbrs) and eq(port.status, ref.status)
    assert eq(port.alive, ref.alive) and eq(port.free, ref.free)
    assert eq(port.plane.data, ref.plane.data)
    assert (port.rerank is None) == (ref.rerank is None)
    if port.rerank is not None:
        assert eq(port.rerank.data, ref.rerank.data)
    assert port.capacity == ref.capacity and port.live_count() == ref.live_count()


@pytest.mark.parametrize("tag", ["f32", "bf16", "int8", "pq"])
@pytest.mark.parametrize("masks", [False, True])
def test_allocator_matches_reference(tag, masks):
    port, ref = store_pair(tag, masks=masks)
    assert_store_arrays_equal(port, ref)
    p_alive, p_free = port.masks()
    r_alive, r_free = ref.masks()
    assert np.array_equal(p_alive.numpy(), np.asarray(r_alive))
    assert np.array_equal(p_free.numpy(), np.asarray(r_free))
    for m_full in (3, 5, 12):
        assert_store_arrays_equal(port.widen_rows(m_full), ref.widen_rows(m_full))
    n_free = int(p_free.sum())
    for need in (0, n_free, n_free + 1, 45, 200):
        p, r = port.grow(need, 12), ref.grow(need, 12)
        assert_store_arrays_equal(p, r)
        assert int(p.free.sum()) >= need
        assert (p.entry is None) == (p.capacity > port.capacity)
    grown = port.grow(n_free + 1, 12)
    assert grown.capacity == max(2 * port.capacity, 64)
    virgin = slice(port.capacity, None)
    assert bool((grown.intervals[virgin] == torch.tensor([2.0, -2.0])).all())
    assert bool((grown.nbrs[virgin] == -1).all()) and bool(grown.free[virgin].all())
