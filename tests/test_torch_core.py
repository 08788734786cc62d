"""The port's core modules against the reference, bitwise, on the CPU.

Inputs are made with numpy from a seed and handed to both packages.  Interval
data is drawn from small grids, so endpoints repeat and point and empty
intervals occur; subnormal endpoints are kept out (XLA on the CPU flushes
them to zero, PyTorch does not).  Vectors are integer-valued, so every
distance is exact whatever the summation order.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import candidates as ref_cand
from repro.core import entry as ref_entry
from repro.core import intervals as ref_iv
from repro.core import prune as ref_prune
from repro_torch.core import candidates as port_cand
from repro_torch.core import entry as port_entry
from repro_torch.core import intervals as port_iv
from repro_torch.core import prune as port_prune

GRID = [0.0, 0.25, 0.5, 0.75, 1.0]


def grid_intervals(rng, n, *, sort=True):
    ends = rng.choice(GRID, size=(n, 2)).astype(np.float32)
    return np.sort(ends, axis=-1) if sort else ends


def test_constants_and_semantics_match():
    assert (port_iv.FLAG_IF, port_iv.FLAG_IS, port_iv.FLAG_BOTH) == (
        ref_iv.FLAG_IF, ref_iv.FLAG_IS, ref_iv.FLAG_BOTH)
    for s in port_iv.Semantics:
        assert s.flag == ref_iv.Semantics(s.value).flag


def test_interval_algebra_matches_on_grid():
    """All pairs of grid intervals, including points ([a, a]) and empty
    (inverted) ones."""
    pairs = np.asarray(list(itertools.product(GRID, GRID)), np.float32)   # (25, 2)
    a = np.repeat(pairs, len(pairs), axis=0)
    b = np.tile(pairs, (len(pairs), 1))
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    for fn in ("hull", "intersection"):
        assert np.array_equal(getattr(port_iv, fn)(ta, tb).numpy(),
                              np.asarray(getattr(ref_iv, fn)(ja, jb)))
    assert np.array_equal(port_iv.is_empty(ta).numpy(), np.asarray(ref_iv.is_empty(ja)))
    assert np.array_equal(port_iv.contains(ta, tb).numpy(), np.asarray(ref_iv.contains(ja, jb)))
    for s in port_iv.Semantics:
        assert np.array_equal(port_iv.predicate(s, ta, tb).numpy(),
                              np.asarray(ref_iv.predicate(ref_iv.Semantics(s.value), ja, jb)))
    flags = np.where(np.arange(len(a)) % 3 == 0, 1, 2).astype(np.int32)
    assert np.array_equal(
        port_iv.predicate_by_flag(torch.as_tensor(flags), ta, tb).numpy(),
        np.asarray(ref_iv.predicate_by_flag(jnp.asarray(flags), ja, jb)))
    assert np.array_equal(port_iv.is_filter_flag(torch.as_tensor(flags)).numpy(),
                          np.asarray(ref_iv.is_filter_flag(jnp.asarray(flags))))


def test_as_sem_flags_matches_and_validates():
    sems = [port_iv.Semantics.IF, port_iv.Semantics.IS, port_iv.Semantics.RS, port_iv.Semantics.RF]
    ref_sems = [ref_iv.Semantics(s.value) for s in sems]
    assert np.array_equal(port_iv.as_sem_flags(sems, 4).numpy(),
                          np.asarray(ref_iv.as_sem_flags(ref_sems, 4)))
    assert np.array_equal(port_iv.as_sem_flags(port_iv.Semantics.RS, 3).numpy(),
                          np.asarray(ref_iv.as_sem_flags(ref_iv.Semantics.RS, 3)))
    for bad in ([0, 1], [1, 3]):
        with pytest.raises(ValueError):
            port_iv.as_sem_flags(bad, 2)
    with pytest.raises(ValueError):
        port_iv.as_sem_flags([1, 2, 1], 2)


@pytest.mark.parametrize("n,masked", [(40, False), (40, True), (300, False), (1, False)])
def test_entry_index_matches_on_repeated_endpoints(n, masked):
    rng = np.random.default_rng(n + masked)
    ints = grid_intervals(rng, n)
    mask = rng.uniform(size=n) < 0.7 if masked else None
    want = jax.jit(ref_entry.build_entry_index)(
        jnp.asarray(ints), None if mask is None else jnp.asarray(mask))
    got = port_entry.build_entry_index(torch.as_tensor(ints),
                                       None if mask is None else torch.as_tensor(mask))
    for g, w in zip(got.arrays(), want):
        assert np.array_equal(g.numpy(), np.asarray(w))

    nq = 64
    q = grid_intervals(rng, nq)
    q[::5, 1] = q[::5, 0]                              # point (RS) windows
    flags = rng.choice([1, 2], size=nq).astype(np.int32)
    ref_batch = jax.jit(ref_entry.get_entry_batch_flags, static_argnums=3)
    for width in (1, 4):
        w_ids = ref_batch(want, jnp.asarray(q), jnp.asarray(flags), width)
        g_ids = port_entry.get_entry_batch_flags(got, torch.as_tensor(q), torch.as_tensor(flags), width)
        assert np.array_equal(g_ids.numpy(), np.asarray(w_ids))


@pytest.mark.parametrize("grid,ef_attribute", [(True, 32), (False, 64)])
def test_attribute_candidates_match(grid, ef_attribute):
    rng = np.random.default_rng(ef_attribute)
    n = 150
    ints = grid_intervals(rng, n) if grid else np.sort(
        rng.uniform(size=(n, 2)), axis=-1).astype(np.float32)
    want = ref_cand.attribute_candidates(jnp.asarray(ints), ef_attribute)
    got = port_cand.attribute_candidates(torch.as_tensor(ints), ef_attribute)
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n,d,k", [(200, 8, 10), (97, 5, 16)])
def test_brute_force_knn_matches_on_integer_data(n, d, k):
    rng = np.random.default_rng(n)
    x = rng.integers(-3, 4, (n, d)).astype(np.float32)       # many exact ties
    want = ref_cand.brute_force_knn(jnp.asarray(x), k)
    got = port_cand.brute_force_knn(torch.as_tensor(x), k)
    assert np.array_equal(got.ids.numpy(), np.asarray(want.ids))
    assert np.array_equal(got.dist.numpy(), np.asarray(want.dist))


@pytest.mark.parametrize("alpha,unified", [(1.0, True), (1.2, True), (1.0, False)])
def test_unified_prune_matches_on_integer_data(alpha, unified):
    rng = np.random.default_rng(int(alpha * 10) + unified)
    n, d, B, C = 120, 6, 24, 40
    x = rng.integers(-3, 4, (n, d)).astype(np.float32)
    ints = grid_intervals(rng, n)
    u = rng.choice(n, B, replace=False).astype(np.int32)
    cand = rng.integers(-1, n, (B, C)).astype(np.int32)
    cand[:, 0] = u                                           # self edges
    cand[:, 1] = cand[:, 2]                                  # duplicates
    kw = dict(m_if=6, m_is=6, alpha=alpha, unified=unified)
    want = ref_prune.unified_prune(jnp.asarray(u), jnp.asarray(cand), jnp.asarray(x),
                                   jnp.asarray(ints), backend="xla", **kw)
    got = port_prune.unified_prune(torch.as_tensor(u), torch.as_tensor(cand), torch.as_tensor(x),
                                   torch.as_tensor(ints), **kw)
    for name in ("order", "dist", "status", "repair_if", "repair_is"):
        assert np.array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name))), name
