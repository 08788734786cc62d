"""The port's plain kernel versions against the reference's XLA twins, on the CPU.

Inputs are made once with numpy from a seed and handed to both packages.
``prune_sweep``, ``beam_merge``, ``dedup_first`` and ``segment_scatter``
agree bitwise (``prune_sweep`` on integer-valued vectors, where every
distance is exact in any summation order).  ``expand_score`` agrees bitwise
on integer-valued data and to ``rtol=1e-5`` on Gaussian data, because XLA's
order of the sum over ``d`` is not the port's fixed lane order.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import beam_merge as ref_bm
from repro.kernels import expand_score as ref_es
from repro.kernels import prune_sweep as ref_ps
from repro.kernels import ref as ref_oracles
from repro.kernels import util as ref_util
from repro_torch.kernels import beam_merge as port_bm
from repro_torch.kernels import ops
from repro_torch.kernels import ref as port_oracles
from repro_torch.kernels import util as port_util
from repro_torch.kernels.beam_merge import PAD_PAYLOAD
from repro_torch.kernels.expand_score import dedup_first, dedup_first_quadratic


def f32_bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def assert_bitwise(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.array_equal(f32_bits(got), f32_bits(want))


# ------------------------------------------------------------- prune_sweep
def prune_case(seed, B, C, d, *, point=False, pad_frac=0.2):
    """Preprocessed sweep inputs with integer-valued vectors, point
    intervals on request, and all-pad rows."""
    rng = np.random.default_rng(seed)
    xs = rng.integers(-4, 5, size=(B, C, d)).astype(np.float32)
    i_c = np.sort(rng.choice([0.0, 0.25, 0.5, 0.75, 1.0], size=(B, C, 2)), axis=-1).astype(np.float32)
    if point:
        i_c[..., 1] = i_c[..., 0]
    i_u = np.sort(rng.uniform(size=(B, 2)), axis=-1).astype(np.float32)
    d_uc = np.sort(rng.integers(1, 8 * d, size=(B, C)), axis=-1).astype(np.float32)
    valid = rng.uniform(size=(B, C)) >= pad_frac
    valid[B // 2] = False                                  # an all-pad row
    d_uc[~valid] = np.inf
    overlap = np.maximum(i_u[:, None, 0], i_c[..., 0]) <= np.minimum(i_u[:, None, 1], i_c[..., 1])
    return i_u, xs, i_c, d_uc, valid, overlap


@pytest.mark.parametrize("B,C,d", [(1, 8, 4), (5, 33, 16), (16, 96, 24), (3, 5, 2)])
@pytest.mark.parametrize("alpha", [1.0, 1.2])
@pytest.mark.parametrize("unified", [True, False])
def test_prune_sweep_matches_reference(B, C, d, alpha, unified):
    case = prune_case(B * 1000 + C + d, B, C, d, point=(C % 2 == 1))
    kw = dict(m_if=8, m_is=8, alpha=alpha, unified=unified)
    want = ref_ps.prune_sweep_xla(*map(jnp.asarray, case), **kw)
    got = ops.prune_sweep(*map(torch.as_tensor, case), **kw)
    for g, w in zip(got, want):
        assert_bitwise(g, w)


# ------------------------------------------------------------ expand_score
def expand_case(seed, n, d, B, C, integer):
    rng = np.random.default_rng(seed)
    if integer:
        x = rng.integers(-8, 9, (n, d)).astype(np.float32)
        q = rng.integers(-8, 9, (B, d)).astype(np.float32)
    else:
        x = rng.normal(size=(n, d)).astype(np.float32)
        q = rng.normal(size=(B, d)).astype(np.float32)
    idx = rng.integers(-1, n, (B, C)).astype(np.int32)
    return x, idx, q


@pytest.mark.parametrize("n,d,B,C", [(50, 8, 3, 5), (300, 24, 17, 40), (200, 40, 6, 64)])
def test_expand_score_integer_bitwise(n, d, B, C):
    x, idx, q = expand_case(n + d, n, d, B, C, integer=True)
    want = ref_es.expand_score_xla(jnp.asarray(x), jnp.asarray(idx), jnp.asarray(q))
    got = ops.expand_score(torch.as_tensor(x), torch.as_tensor(idx), torch.as_tensor(q))
    assert_bitwise(got, want)
    assert_bitwise(port_oracles.gather_sq_dist(*map(torch.as_tensor, (x, idx, q))), want)


@pytest.mark.parametrize("n,d,B,C", [(300, 24, 17, 40), (200, 128, 8, 64)])
def test_expand_score_gaussian_close(n, d, B, C):
    x, idx, q = expand_case(7 * n + d, n, d, B, C, integer=False)
    want = np.asarray(ref_es.expand_score_xla(jnp.asarray(x), jnp.asarray(idx), jnp.asarray(q)))
    got = ops.expand_score(torch.as_tensor(x), torch.as_tensor(idx), torch.as_tensor(q)).numpy()
    assert np.array_equal(np.isinf(got), idx < 0)
    assert np.array_equal(np.isinf(want), idx < 0)
    ok = idx >= 0
    np.testing.assert_allclose(got[ok], want[ok], rtol=1e-5, atol=0)


# -------------------------------------------------------------- beam_merge
def beam_case(seed, B, E, L, inf_frac=0.3):
    rng = np.random.default_rng(seed)
    pool = [0.25, 0.5, 1.0, 2.0]
    bd = rng.choice(pool, size=(B, E)).astype(np.float32)
    bd[rng.uniform(size=(B, E)) < inf_frac] = np.inf
    bp = (rng.integers(0, 500, (B, E)) << 1).astype(np.int32)
    bp = np.where(np.isfinite(bd), bp, PAD_PAYLOAD).astype(np.int32)
    o = np.lexsort((bp, bd), axis=-1)
    bd = np.take_along_axis(bd, o, -1)
    bp = np.take_along_axis(bp, o, -1)
    cd = rng.choice(pool + [np.inf], size=(B, L)).astype(np.float32)
    cp = np.where(np.isfinite(cd), (rng.integers(0, 500, (B, L)) << 1) | rng.integers(0, 2, (B, L)),
                  PAD_PAYLOAD).astype(np.int32)
    return bd, bp, cd, cp


@pytest.mark.parametrize("B,E,L", [(1, 8, 8), (5, 16, 48), (9, 64, 128),
                                   (3, 64, 5), (2, 8, 200), (7, 32, 32)])
def test_beam_merge_matches_reference(B, E, L):
    case = beam_case(B * 100 + E + L, B, E, L)
    want = ref_bm.beam_merge_xla(*map(jnp.asarray, case))
    oracle = ref_oracles.beam_merge(*map(jnp.asarray, case))
    got = ops.beam_merge(*map(torch.as_tensor, case))
    port_oracle = port_oracles.beam_merge(*map(torch.as_tensor, case))
    for g, w, o, po in zip(got, want, oracle, port_oracle):
        assert_bitwise(g, w)
        assert_bitwise(g, o)
        assert_bitwise(po, o)


def test_beam_merge_rejects_non_power_of_two():
    bd, bp, cd, cp = map(torch.as_tensor, beam_case(0, 2, 8, 8))
    with pytest.raises(ValueError):
        ops.beam_merge(bd[:, :6], bp[:, :6], cd, cp)


def edge_beams(rng, B, E):
    """Unsorted beams with NaN, -0.0, +0.0 and ``(inf, id << 1)`` entries."""
    bd = rng.choice([0.5, 1.0, np.nan, np.inf, -0.0, 0.0], size=(B, E)).astype(np.float32)
    bp = (rng.integers(0, 500, (B, E)) << 1).astype(np.int32)
    bp[:, ::4] = PAD_PAYLOAD
    return bd, bp


@pytest.mark.parametrize("E,L", [(8, 8), (16, 5), (64, 256)])
def test_beam_merge_edge_keys_match_reference(E, L):
    """NaN and -0.0 in beam and candidates: the port's network puts them
    where the reference's does."""
    rng = np.random.default_rng(E + L)
    bd, bp = edge_beams(rng, 6, E)
    cd = rng.choice([0.5, 1.0, np.nan, np.inf, -0.0, 0.0], size=(6, L)).astype(np.float32)
    cp = (rng.integers(0, 500, (6, L)) << 1).astype(np.int32)
    case = (bd, bp, cd, cp)
    want = ref_bm.beam_merge_xla(*map(jnp.asarray, case))
    for g, w in zip(ops.beam_merge(*map(torch.as_tensor, case)), want):
        assert_bitwise(g, w)


@pytest.mark.parametrize("E,L", [(8, 8), (16, 5), (64, 256)])
def test_beam_merge_all_pad_candidates_skip_the_sort(E, L):
    """The CUDA kernel skips the sort where every candidate is
    ``(+inf, PAD_PAYLOAD)``: the whole network then equals the reversed
    minimum and the merge stages alone, on any beam, and the reference's."""
    rng = np.random.default_rng(E * L)
    bd, bp = edge_beams(rng, 6, E)
    cd = np.full((6, L), np.inf, np.float32)
    cp = np.full((6, L), PAD_PAYLOAD, np.int32)
    got = ops.beam_merge(*map(torch.as_tensor, (bd, bp, cd, cp)))
    want = ref_bm.beam_merge_xla(*map(jnp.asarray, (bd, bp, cd, cp)))
    pads_d = torch.full((6, E), torch.inf)
    pads_p = torch.full((6, E), PAD_PAYLOAD, dtype=torch.int32)
    no_sort = port_bm._merge_block(torch.as_tensor(bd), torch.as_tensor(bp), pads_d, pads_p)
    for g, w, s in zip(got, want, no_sort):
        assert_bitwise(g, w)
        assert_bitwise(g, s.numpy())


# ------------------------------------------------------------------- dedup
@pytest.mark.parametrize("B,C,id_range", [(4, 16, 6), (9, 64, 20), (3, 256, 300)])
def test_dedup_first_matches_reference(B, C, id_range):
    rng = np.random.default_rng(B + C)
    ids = rng.integers(0, id_range, (B, C)).astype(np.int32)
    flag = rng.uniform(size=(B, C)) < 0.7
    want = np.asarray(ref_es.dedup_first(jnp.asarray(ids), jnp.asarray(flag)))
    got = dedup_first(torch.as_tensor(ids), torch.as_tensor(flag)).numpy()
    quad = dedup_first_quadratic(torch.as_tensor(ids), torch.as_tensor(flag)).numpy()
    ref_quad = np.asarray(ref_es.dedup_first_quadratic(jnp.asarray(ids), jnp.asarray(flag)))
    assert np.array_equal(got, want)
    assert np.array_equal(quad, want)
    assert np.array_equal(ref_quad, want)


# --------------------------------------------------------- segment_scatter
@pytest.mark.parametrize("n,width,pairs", [(1, 1, 3), (10, 3, 80), (57, 8, 1000)])
def test_segment_scatter_matches_reference(n, width, pairs):
    rng = np.random.default_rng(n * width)
    seg = rng.integers(-2, n + 2, pairs).astype(np.int32)
    val = rng.integers(-2, 3 * n, pairs).astype(np.int32)
    want = np.asarray(ref_util.segment_scatter(jnp.asarray(seg), jnp.asarray(val), n, width))
    got = port_util.segment_scatter(torch.as_tensor(seg), torch.as_tensor(val), n, width).numpy()
    assert np.array_equal(got, want)
