"""The port's scan kernels (plain versions) against the reference, on the CPU.

``pairwise_sq_dist`` and ``filtered_topk`` are held against the reference's
Pallas kernels (interpret mode, through ``repro.kernels.ops``) and its
oracles (``repro.kernels.ref``) on the shapes of ``tests/test_kernels.py``.
On Gaussian data the sums run in other orders (XLA's, and a norm partial per
512-wide ``d`` tile in the Pallas kernel), so values agree to tolerance and
top-k ids as sets.  On small integer data every sum is exact and the port
agrees bit for bit; repeated corpus rows there give exact ties, which the
port breaks by the lower id, as the oracle's ``lax.top_k`` does.  (The
Pallas kernel inserts an equal distance ahead of the entries it already
holds, so on ties it keeps later ids: its ids are compared below the k-th
distance only.)

The CUDA kernels' arithmetic (3×TF32 tensor-core products, which sum in
another order than the plain versions) is emulated in numpy and held to the
rules the card tests hold the kernels to: ``l2dist.tolerance`` and
``fused_scan.rule_violations``, whose teeth are tested too.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_oracles
from repro_torch.kernels import cuda_lib, fused_scan, l2dist, ops
from repro_torch.kernels import ref as port_oracles
from repro_torch.kernels.fused_scan import MAX_K


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The shapes here are small: torch's intra-op pool only contends with
    the other test processes and the reference's XLA threads, so this module
    runs torch on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def f32_bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def to_np(t) -> np.ndarray:
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def assert_bitwise(got, want):
    got, want = to_np(got), to_np(want)
    assert got.shape == want.shape
    assert np.array_equal(f32_bits(got), f32_bits(want))


def both(a: np.ndarray, dtype: str = "f32"):
    """The same array for both packages; bf16 rounds to nearest even in
    both, from the same f32 values."""
    j, t = jnp.asarray(a), torch.as_tensor(a)
    if dtype == "bf16":
        j, t = j.astype(jnp.bfloat16), t.to(torch.bfloat16)
        assert np.array_equal(np.asarray(j.astype(jnp.float32)), t.float().numpy())
    return j, t


def scan_case(seed, nq, nx, d, *, integer=False, half=0.35):
    """Queries, corpus, object intervals and query windows.  Integer data
    repeats the first half of the corpus rows; every fifth window is
    [2, 3], which no object passes in either direction."""
    rng = np.random.default_rng(seed)
    if integer:
        x = rng.integers(-3, 4, (nx, d)).astype(np.float32)
        x[nx // 2 :] = x[: nx - nx // 2]
        q = rng.integers(-3, 4, (nq, d)).astype(np.float32)
        oi = np.sort(rng.choice([0.0, 0.25, 0.5, 0.75, 1.0], size=(nx, 2)), axis=1)
    else:
        x = rng.normal(size=(nx, d)).astype(np.float32)
        q = rng.normal(size=(nq, d)).astype(np.float32)
        oi = np.sort(rng.uniform(size=(nx, 2)), axis=1)
    c = rng.uniform(size=(nq, 1))
    qi = np.concatenate([np.maximum(c - half, 0), np.minimum(c + half, 1)], axis=1)
    qi[::5] = (2.0, 3.0)
    return q, x, oi.astype(np.float32), qi.astype(np.float32)


# ------------------------------------------------------------ pairwise_sq_dist
@pytest.mark.parametrize("nq,nx,d", [(3, 5, 4), (17, 33, 7), (64, 128, 32),
                                     (100, 257, 96), (8, 1024, 128)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_pairwise_sq_dist_matches_reference(nq, nx, d, dtype):
    q, x, _, _ = scan_case(nq * 1000 + nx, nq, nx, d)
    (jq, tq), (jx, tx) = both(q, dtype), both(x, dtype)
    want = np.asarray(ref_ops.pairwise_sq_dist(jq, jx))
    got = ops.pairwise_sq_dist(tq, tx).numpy()
    tol = 1e-4 if dtype == "f32" else 5e-2
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)
    np.testing.assert_allclose(port_oracles.pairwise_sq_dist(tq, tx).numpy(),
                               np.asarray(ref_oracles.pairwise_sq_dist(jq, jx)),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("nq,nx,d", [(3, 5, 4), (17, 33, 7), (64, 128, 32), (9, 300, 64)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_pairwise_sq_dist_integer_bitwise(nq, nx, d, dtype):
    q, x, _, _ = scan_case(nq + nx + d, nq, nx, d, integer=True)
    (jq, tq), (jx, tx) = both(q, dtype), both(x, dtype)
    got = ops.pairwise_sq_dist(tq, tx)
    assert got.dtype == torch.float32
    assert_bitwise(got, ref_ops.pairwise_sq_dist(jq, jx))
    assert_bitwise(got, ref_oracles.pairwise_sq_dist(jq, jx))
    assert_bitwise(port_oracles.pairwise_sq_dist(tq, tx), got)


def test_pairwise_sq_dist_mixed_dtypes_widen_exactly():
    q, x, _, _ = scan_case(3, 6, 40, 12)
    tq, tx = torch.as_tensor(q), torch.as_tensor(x).to(torch.bfloat16)
    assert_bitwise(ops.pairwise_sq_dist(tq, tx), ops.pairwise_sq_dist(tq, tx.float()))


def tf32_rna(a: np.ndarray) -> np.ndarray:
    """float32 → TF32 (10 mantissa bits), round half away from zero, as
    ``cvt.rna.tf32.f32``: add half a unit of the 13 dropped bits, mask."""
    bits = np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def sq_dist_3xtf32(q: np.ndarray, x: np.ndarray) -> np.ndarray:
    """The kernel's arithmetic in numpy: the plain version's folded norms,
    and an inner product of TF32 parts and TF32 remainders, three products
    a ``k`` (small·big, big·small, big·big) summed in f32 in that order."""
    qb, xb = tf32_rna(q), tf32_rna(x)
    qs, xs = tf32_rna(q - qb), tf32_rna(x - xb)
    acc = np.zeros((q.shape[0], x.shape[0]), dtype=np.float32)
    for k in range(q.shape[1]):
        acc = acc + qs[:, k : k + 1] * xb[None, :, k]
        acc = acc + qb[:, k : k + 1] * xs[None, :, k]
        acc = acc + qb[:, k : k + 1] * xb[None, :, k]
    qn = l2dist.fold_sq_norms(torch.as_tensor(q)).numpy()
    xn = l2dist.fold_sq_norms(torch.as_tensor(x)).numpy()
    d = (qn[:, None] + xn[None, :]) - np.float32(2.0) * acc
    return np.maximum(d, np.float32(0.0))


@pytest.mark.parametrize("d", [7, 128, 200])
@pytest.mark.parametrize("seed", [0, 1])
def test_3xtf32_arithmetic_within_stated_bound(d, seed):
    """The bound the card tests hold the kernel to, held to the design's
    arithmetic: on Gaussian data the emulated 3×TF32 distances stay within
    ``(d + 4)·2⁻²³·(‖q‖² + ‖x‖²)`` of the plain fold, and use some of it
    (a TF32 product alone would not stay within it)."""
    q, x, _, _ = scan_case(seed * 100 + d, 33, 70, d)
    got = sq_dist_3xtf32(q, x)
    want = l2dist.pairwise_sq_dist_torch(torch.as_tensor(q), torch.as_tensor(x)).numpy()
    tol = l2dist.tolerance(torch.as_tensor(q), torch.as_tensor(x)).numpy()
    err = np.abs(got.astype(np.float64) - want)
    assert (err <= tol).all(), float((err / tol).max())
    one_tf32 = np.maximum(
        l2dist.fold_sq_norms(torch.as_tensor(q)).numpy()[:, None]
        + l2dist.fold_sq_norms(torch.as_tensor(x)).numpy()[None, :]
        - 2 * (tf32_rna(q).astype(np.float64) @ tf32_rna(x).astype(np.float64).T), 0)
    assert (np.abs(one_tf32 - want) > tol).any()


@pytest.mark.parametrize("d", [7, 128, 200])
def test_3xtf32_arithmetic_integer_bitwise(d):
    """|v| ≤ 8 integers: the remainders are 0 and every sum is exact."""
    rng = np.random.default_rng(d)
    q = rng.integers(-8, 9, (9, d)).astype(np.float32)
    x = rng.integers(-8, 9, (40, d)).astype(np.float32)
    assert not tf32_rna(q - tf32_rna(q)).any()
    assert_bitwise(sq_dist_3xtf32(q, x),
                   l2dist.pairwise_sq_dist_torch(torch.as_tensor(q), torch.as_tensor(x)))


# --------------------------------------------------------------- filtered_topk
def id_sets(vals, ids, below=None):
    """Per row, the ids with a finite value (or a value below ``below``)."""
    vals, ids = to_np(vals), to_np(ids)
    keep = np.isfinite(vals) if below is None else vals < below[:, None]
    return [set(ids[r][keep[r]].tolist()) for r in range(vals.shape[0])]


@pytest.mark.parametrize("nq,nx,d,k", [(5, 100, 8, 5), (13, 500, 24, 10),
                                       (32, 999, 16, 10), (4, 64, 8, 20)])
@pytest.mark.parametrize("is_filter", [True, False])
def test_filtered_topk_matches_reference(nq, nx, d, k, is_filter):
    q, x, oi, qi = scan_case(nq + nx, nq, nx, d)
    kw = dict(is_filter=is_filter, k=k)
    rv, ri = ref_ops.filtered_topk(*map(jnp.asarray, (q, x, oi, qi)), **kw)
    v, i = ops.filtered_topk(*map(torch.as_tensor, (q, x, oi, qi)), **kw)
    rv = np.asarray(rv)
    finite = np.isfinite(rv)
    assert np.array_equal(np.isfinite(v.numpy()), finite)
    np.testing.assert_allclose(np.where(finite, v.numpy(), 0), np.where(finite, rv, 0), atol=1e-4)
    assert id_sets(v, i) == id_sets(rv, ri)
    assert np.array_equal(i.numpy() >= 0, finite)
    assert (i.numpy()[::5] == -1).all()      # the [2, 3] windows


@pytest.mark.parametrize("nq,nx,d,k", [(5, 100, 8, 5), (13, 500, 24, 10), (32, 999, 16, 10),
                                       (4, 64, 8, 20), (6, 9, 4, 16)])
@pytest.mark.parametrize("is_filter", [True, False])
def test_filtered_topk_integer_bitwise(nq, nx, d, k, is_filter):
    """Exact ties between repeated rows: values and ids equal the oracle's
    (lower id first); against the Pallas kernel the values are equal and
    the ids below each row's k-th value.  (6, 9, 4, 16) has k > nx."""
    q, x, oi, qi = scan_case(7 * nq + d, nq, nx, d, integer=True)
    kw = dict(is_filter=is_filter, k=k)
    j = tuple(map(jnp.asarray, (q, x, oi, qi)))
    t = tuple(map(torch.as_tensor, (q, x, oi, qi)))
    v, i = ops.filtered_topk(*t, **kw)
    # the oracle's lax.top_k takes k <= nx: pad its answer as the kernels do
    ov, oid = ref_oracles.filtered_topk(*j, is_filter=is_filter, k=min(k, nx))
    pad = ((0, 0), (0, k - min(k, nx)))
    assert_bitwise(v, np.pad(np.asarray(ov), pad, constant_values=np.inf))
    assert_bitwise(i, np.pad(np.asarray(oid), pad, constant_values=-1))
    pv, pid = port_oracles.filtered_topk(*t, **kw)
    assert_bitwise(pv, v)
    assert_bitwise(pid, i)
    kv, kid = ref_ops.filtered_topk(*j, **kw)
    assert_bitwise(v, kv)
    kth = to_np(kv)[:, -1]
    assert id_sets(v, i, below=kth) == id_sets(kv, kid, below=kth)


def test_filtered_topk_k_above_nx_and_excluded_rows():
    q, x, oi, qi = scan_case(11, 7, 6, 5, integer=True)
    v, i = ops.filtered_topk(*map(torch.as_tensor, (q, x, oi, qi)), is_filter=False, k=9)
    assert v.shape == (7, 9) and i.dtype == torch.int32
    assert bool(torch.isinf(v[:, 6:]).all()) and bool((i[:, 6:] == -1).all())
    assert bool(torch.isinf(v[::5]).all()) and bool((i[::5] == -1).all())
    assert bool((torch.diff(v, dim=1).nan_to_num(0.0) >= 0).all())


def test_filtered_topk_is_exact_prefilter():
    """The scan is the pre-filter baseline: its ids are the exact
    brute-force truth's (the contract of tests/test_kernels.py)."""
    from repro_torch.core import Semantics
    from repro_torch.core.baselines import prefilter_search

    q, x, oi, qi = map(torch.as_tensor, scan_case(5, 10, 220, 8, half=0.3))
    for sem, is_filter in ((Semantics.IF, True), (Semantics.IS, False)):
        v, i = ops.filtered_topk(q, x, oi, qi, is_filter=is_filter, k=10)
        truth = prefilter_search(x, oi, q, qi, sem=sem, k=10)
        assert id_sets(v, i) == [set(r[r >= 0].tolist()) for r in truth.ids.numpy()]
        np.testing.assert_allclose(v.numpy(), truth.dist.numpy(), rtol=1e-5)


@pytest.mark.parametrize("k", [0, MAX_K + 1])
def test_filtered_topk_refuses_k_out_of_range(k):
    q, x, oi, qi = map(torch.as_tensor, scan_case(1, 3, 20, 4))
    with pytest.raises(ValueError):
        ops.filtered_topk(q, x, oi, qi, is_filter=True, k=k)


def topk_3xtf32(q, x, oi, qi, *, is_filter: bool, k: int):
    """The CUDA kernel's arithmetic in numpy: the emulated 3×TF32 distances,
    the predicate, and a stable top-k (the lower id first on ties), padded
    with ``(+inf, -1)``."""
    d = sq_dist_3xtf32(q, x)
    o, w = oi[None, :, :], qi[:, None, :]
    if is_filter:
        ok = (o[..., 0] >= w[..., 0]) & (o[..., 1] <= w[..., 1])
    else:
        ok = (o[..., 0] <= w[..., 0]) & (o[..., 1] >= w[..., 1])
    d = np.where(ok, d, np.float32(np.inf))
    order = np.argsort(d, axis=1, kind="stable")[:, :k]
    vals = np.take_along_axis(d, order, axis=1)
    pad = k - vals.shape[1]
    vals = np.pad(vals, ((0, 0), (0, pad)), constant_values=np.inf)
    ids = np.pad(order.astype(np.int32), ((0, 0), (0, pad)), constant_values=-1)
    return vals, np.where(np.isfinite(vals), ids, -1).astype(np.int32)


@pytest.mark.parametrize("d", [7, 128, 200])
@pytest.mark.parametrize("is_filter", [True, False])
def test_filtered_topk_3xtf32_model_within_rule(d, is_filter):
    """The rule the card tests hold the kernel to, held to the design's
    arithmetic on Gaussian data: the emulated kernel against the plain
    version, through ``fused_scan.rule_violations``."""
    q, x, oi, qi = scan_case(d + 17 * is_filter, 23, 400, d)
    t = tuple(map(torch.as_tensor, (q, x, oi, qi)))
    got = tuple(map(torch.as_tensor, topk_3xtf32(q, x, oi, qi, is_filter=is_filter, k=10)))
    want = fused_scan.filtered_topk_torch(*t, is_filter=is_filter, k=10)
    assert fused_scan.rule_violations(*t, is_filter=is_filter, got=got, want=want) == []


@pytest.mark.parametrize("d", [7, 128, 200])
@pytest.mark.parametrize("k", [1, 10, 64])
def test_filtered_topk_3xtf32_model_integer_bitwise(d, k):
    """|v| ≤ 8 integers with repeated rows: the emulated kernel equals the
    plain version bit for bit, values and ids (ties by the lower id)."""
    rng = np.random.default_rng(d * k)
    q = rng.integers(-8, 9, (17, d)).astype(np.float32)
    x = rng.integers(-8, 9, (300, d)).astype(np.float32)
    x[150:] = x[:150]
    _, _, oi, qi = scan_case(d + k, 17, 300, 4, integer=True)
    for is_filter in (True, False):
        vals, ids = topk_3xtf32(q, x, oi, qi, is_filter=is_filter, k=k)
        pv, pid = fused_scan.filtered_topk_torch(*map(torch.as_tensor, (q, x, oi, qi)),
                                                 is_filter=is_filter, k=k)
        assert_bitwise(pv, vals)
        assert_bitwise(pid, ids)


@pytest.mark.parametrize("fault", ["farther_id", "repeated_id", "excluded_id", "value",
                                   "inf_pattern", "unsorted"])
def test_filtered_topk_rule_rejects_a_wrong_answer(fault):
    """The rule is not vacuous: the plain answer passes it, and the same
    answer with one fault does not, the clause that names the fault among
    those it reports."""
    q, x, oi, qi = map(torch.as_tensor, scan_case(31, 12, 500, 16, half=0.4))
    want = fused_scan.filtered_topk_torch(q, x, oi, qi, is_filter=True, k=10)
    assert fused_scan.rule_violations(q, x, oi, qi, is_filter=True, got=want, want=want) == []
    vals, ids = want[0].clone(), want[1].clone()
    row = 1
    ok = fused_scan.passes(oi, qi[row : row + 1], True)[0]
    dist = l2dist.pairwise_sq_dist_torch(q[row : row + 1], x)[0]
    if fault == "farther_id":        # a passing object far beyond the k-th, same value
        ids[row, 3] = int(torch.where(ok, dist, -1.0).argmax())
        clause = "(c)"
    elif fault == "repeated_id":
        ids[row, 3] = ids[row, 2]
        clause = "(c)"
    elif fault == "excluded_id":     # the nearest object the window excludes
        ids[row, 3] = int(torch.where(ok, torch.inf, dist).argmin())
        clause = "(c)"
    elif fault == "value":
        vals[row, 9] = vals[row, 9] * 1.01
        clause = "(b)"
    elif fault == "inf_pattern":
        vals[row, 9], ids[row, 9] = torch.inf, -1
        clause = "(a)"
    else:
        vals[row, 3], vals[row, 4] = vals[row, 4].clone(), vals[row, 3].clone()
        clause = "(b)"
    assert bool(torch.isfinite(want[0][row]).all())
    found = fused_scan.rule_violations(q, x, oi, qi, is_filter=True, got=(vals, ids), want=want)
    assert any(f.startswith(clause) for f in found), found


def test_splits_fill_the_block_slots():
    """The corpus ranges fill at least FILL of the card's block slots where
    any count up to MAX_SPLITS can, and never exceed the corpus tiles."""
    slots = fused_scan.BLOCKS_PER_SM * 132
    assert fused_scan.splits_for_slots(10_000, 1_000_000, slots) == 10   # 790 of 792 slots
    assert fused_scan.splits_for_slots(1_000, 1_000_000, slots) == 30    # 240 of 264
    assert fused_scan.splits_for_slots(5, 100, slots) == 1               # one corpus tile
    assert fused_scan.splits_for_slots(77, 3001, slots) == 24            # 24 corpus tiles


# ------------------------------------------------------------- dispatch rules
def test_gather_sq_dist_is_expand_score():
    rng = np.random.default_rng(2)
    x = torch.as_tensor(rng.normal(size=(50, 9)).astype(np.float32))
    q = torch.as_tensor(rng.normal(size=(4, 9)).astype(np.float32))
    idx = torch.as_tensor(rng.integers(-1, 50, (4, 7)).astype(np.int32))
    assert_bitwise(ops.gather_sq_dist(x, idx, q), ops.expand_score(x, idx, q))
    np.testing.assert_allclose(ops.gather_sq_dist(x, idx, q).numpy(),
                               np.asarray(ref_ops.gather_sq_dist(*map(jnp.asarray, (x, idx, q)))),
                               rtol=1e-5)


def test_cpu_tensors_run_the_plain_versions_uncounted():
    cuda_lib.reset_launches()
    q, x, oi, qi = map(torch.as_tensor, scan_case(4, 5, 30, 6))
    ops.pairwise_sq_dist(q, x)
    ops.filtered_topk(q, x, oi, qi, is_filter=True, k=3)
    assert ops.launches["pairwise_sq_dist"] == 0 and ops.launches["filtered_topk"] == 0
    with pytest.raises(ValueError):
        ops.pairwise_sq_dist(q, x, backend="cuda")
    with pytest.raises(ValueError):
        ops.filtered_topk(q, x, oi, qi, is_filter=True, k=3, backend="cuda")
