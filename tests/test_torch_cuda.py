"""Each CUDA kernel of the port against its plain PyTorch version, on the card.

Bitwise (floats compared as bit patterns), at small shapes and at the main
path's shapes; ``pairwise_sq_dist`` and ``filtered_topk``, whose products run
on the tensor cores (3×TF32), within their stated rules
(``kernels.l2dist.tolerance``, ``kernels.fused_scan.rule_violations``) and
bitwise on small-integer data.  Every test decides inside itself whether a card is present
and skips without one.  This file imports neither JAX nor the reference
package, so it runs on a machine with only PyTorch:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.beam_merge import PAD_PAYLOAD

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def bits(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.view(torch.int32) if t.dtype == torch.float32 else t).numpy()


def assert_bitwise(a, b):
    for x, y in zip(a, b):
        assert x.shape == y.shape
        assert np.array_equal(bits(x), bits(y))


def expand_case(dev, n, d, B, C, *, seed=0, integer=False):
    rng = np.random.default_rng(seed)
    if integer:
        x = rng.integers(-8, 9, (n, d)).astype(np.float32)
        q = rng.integers(-8, 9, (B, d)).astype(np.float32)
    else:
        x = rng.normal(size=(n, d)).astype(np.float32)
        q = rng.normal(size=(B, d)).astype(np.float32)
    idx = rng.integers(0, n, (B, C)).astype(np.int32)
    idx[rng.uniform(size=(B, C)) < 0.2] = -1
    return tuple(torch.as_tensor(a, device=dev) for a in (x, idx, q))


@pytest.mark.parametrize("n,d,B,C", [(50, 8, 3, 5), (300, 24, 17, 40), (1000, 33, 9, 64),
                                     (1000, 128, 64, 256)])
@pytest.mark.parametrize("integer", [False, True])
def test_expand_score_matches_plain(dev, n, d, B, C, integer):
    x, idx, q = expand_case(dev, n, d, B, C, integer=integer)
    got = ops.expand_score(x, idx, q, backend="cuda")
    want = ops.expand_score(x, idx, q, backend="torch")
    torch.cuda.synchronize()
    assert_bitwise([got], [want])


def test_expand_score_main_shape(dev):
    x, idx, q = expand_case(dev, 1_000_000, 128, 10_000, 256, seed=1)
    assert_bitwise([ops.expand_score(x, idx, q, backend="cuda")],
                   [ops.expand_score(x, idx, q, backend="torch")])


def mask_rows(idx: np.ndarray) -> np.ndarray:
    """Candidate ids with every third query row wholly masked."""
    idx = idx.copy()
    idx[::3] = -1
    return idx


@pytest.mark.parametrize("n,d,B,C", [(50, 8, 3, 5), (300, 19, 17, 40), (1000, 33, 9, 64),
                                     (1000, 128, 64, 256)])
def test_expand_score_bf16_matches_plain(dev, n, d, B, C):
    x, idx, q = expand_case(dev, n, d, B, C, seed=d)
    x = x.to(torch.bfloat16)
    idx = torch.as_tensor(mask_rows(idx.cpu().numpy()), device=dev)
    assert_bitwise([ops.expand_score(x, idx, q, backend="cuda")],
                   [ops.expand_score(x, idx, q, backend="torch")])


PLANE_DTYPES = [torch.float32, torch.bfloat16]


@pytest.mark.parametrize("d", [1, 7, 8, 31, 64, 100, 128, 129, 256])
@pytest.mark.parametrize("dtype", PLANE_DTYPES)
def test_expand_score_over_d(dev, dtype, d):
    """Rows of 1 to 256 elements: whole 16-byte loads (bf16 d % 8 == 0, f32
    d % 4 == 0) or aligned words (the rest), one to four 128-byte pieces,
    the last one partial; ids >= n (clamped to n - 1) and whole masked
    query rows among the candidates."""
    x, idx, q = expand_case(dev, 300, d, 7, 150, seed=d)
    idx = mask_rows(idx.cpu().numpy())
    idx[1, ::5] = 300 + np.arange(len(idx[1, ::5]))          # ids >= n
    idx = torch.as_tensor(idx, device=dev)
    x = x.to(dtype)
    assert_bitwise([ops.expand_score(x, idx, q, backend="cuda")],
                   [ops.expand_score(x, idx, q, backend="torch")])


@pytest.mark.parametrize("d", [7, 100, 128])
@pytest.mark.parametrize("offset", [1, 2, 3, 4])
@pytest.mark.parametrize("dtype", PLANE_DTYPES)
def test_expand_score_unaligned_rows(dev, dtype, d, offset):
    """A view of the corpus that starts ``offset`` elements past a 16-byte
    boundary: no row is 16-byte aligned where the offset is not a multiple
    of 16 bytes, and (bf16, odd offsets) none is 4-byte aligned."""
    x, idx, q = expand_case(dev, 400, d, 11, 70, seed=d + offset)
    x = x.to(dtype)
    buf = torch.zeros(x.numel() + 16, dtype=dtype, device=dev)
    view = buf[offset : offset + x.numel()].view(x.shape)
    view.copy_(x)
    assert view.is_contiguous() and view.data_ptr() % 16 == offset * x.element_size() % 16
    assert_bitwise([ops.expand_score(view, idx, q, backend="cuda")],
                   [ops.expand_score(x, idx, q, backend="torch")])


@pytest.mark.parametrize("dtype", PLANE_DTYPES)
def test_expand_score_all_masked_and_empty(dev, dtype):
    x, idx, q = expand_case(dev, 100, 128, 6, 200, seed=3)
    x = x.to(dtype)
    got = ops.expand_score(x, torch.full_like(idx, -1), q, backend="cuda")
    assert bool(torch.isinf(got).all() and (got > 0).all())
    for B, C in ((0, 5), (4, 0)):
        empty = ops.expand_score(x, idx[:B, :C].contiguous(), q[:B].contiguous(),
                                 backend="cuda")
        assert empty.shape == (B, C)


def int8_case(dev, n, d, B, C, *, seed=0):
    rng = np.random.default_rng(seed)
    codes = rng.integers(-127, 128, (n, d)).astype(np.int8)
    scale = rng.uniform(0.01, 0.1, d).astype(np.float32)
    zero = rng.normal(size=d).astype(np.float32)
    q = rng.normal(size=(B, d)).astype(np.float32)
    idx = rng.integers(0, n, (B, C)).astype(np.int32)
    idx[rng.uniform(size=(B, C)) < 0.2] = -1
    return tuple(torch.as_tensor(a, device=dev) for a in (codes, scale, zero, mask_rows(idx), q))


@pytest.mark.parametrize("n,d,B,C", [(50, 8, 3, 5), (300, 19, 17, 40), (1000, 33, 9, 64),
                                     (1000, 128, 64, 256), (300, 7, 17, 40), (500, 100, 9, 64),
                                     (500, 129, 9, 130), (500, 256, 5, 300), (60, 33, 7, 1)])
def test_expand_score_q_matches_plain(dev, n, d, B, C):
    """d ∈ {7, 19, 33, 100, 129} reads the rows with aligned words and a
    funnel shift, 8, 128 and 256 with 16-byte loads; d = 129 and 256 take
    two staged pieces of the query; C = 1 leaves most of a block idle."""
    from repro_torch.kernels import expand_score as es

    case = int8_case(dev, n, d, B, C, seed=n + d)
    assert_bitwise([es.expand_score_q_cuda(*case)], [es.expand_score_q_torch(*case)])


@pytest.mark.parametrize("d", [19, 100, 128])
@pytest.mark.parametrize("offset", [1, 2, 3, 4, 8])
def test_expand_score_q_unaligned_rows(dev, d, offset):
    """A view of the codes that starts ``offset`` bytes past a 16-byte
    boundary: no row is 16-byte aligned, nor (offset 1–3) 4-byte aligned."""
    from repro_torch.kernels import expand_score as es

    codes, scale, zero, idx, q = int8_case(dev, 400, d, 11, 70, seed=d + offset)
    buf = torch.zeros(codes.numel() + 16, dtype=torch.int8, device=dev)
    view = buf[offset : offset + codes.numel()].view(codes.shape)
    view.copy_(codes)
    assert view.is_contiguous() and view.data_ptr() % 16 == offset
    assert_bitwise([es.expand_score_q_cuda(view, scale, zero, idx, q)],
                   [es.expand_score_q_torch(codes, scale, zero, idx, q)])


def test_expand_score_q_all_masked(dev):
    from repro_torch.kernels import expand_score as es

    codes, scale, zero, idx, q = int8_case(dev, 100, 128, 6, 200, seed=3)
    got = es.expand_score_q_cuda(codes, scale, zero, torch.full_like(idx, -1), q)
    assert bool(torch.isinf(got).all() and (got > 0).all())


def pq_case(dev, n, m, dsub, B, C, *, seed=0):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 256, (n, m)).astype(np.uint8)
    cb = rng.normal(size=(m, 256, dsub)).astype(np.float32)
    q = rng.normal(size=(B, m * dsub)).astype(np.float32)
    idx = rng.integers(0, n, (B, C)).astype(np.int32)
    idx[rng.uniform(size=(B, C)) < 0.2] = -1
    return tuple(torch.as_tensor(a, device=dev) for a in (codes, cb, mask_rows(idx), q))


@pytest.mark.parametrize("m,dsub,B,C", [(1, 8, 3, 5), (16, 8, 17, 40), (16, 8, 9, 256),
                                        (192, 8, 5, 70), (3, 1, 4, 300)])
def test_expand_score_pq_matches_plain(dev, m, dsub, B, C):
    """m = 192 (d = 1536) stages 196,608 bytes a block, above the 48 KB
    that needs no opt-in."""
    from repro_torch.kernels import expand_score as es

    codes, cb, idx, q = pq_case(dev, 500, m, dsub, B, C, seed=m + C)
    lut = es.pq_lut(cb, q)
    assert_bitwise([es.expand_score_pq_cuda(codes, cb, idx, q, lut=lut)],
                   [es.expand_score_pq_torch(codes, cb, idx, q, lut=lut)])


@pytest.mark.parametrize("m", [1, 3, 16, 17, 32, 64, 192])
@pytest.mark.parametrize("C", [1, 31, 256, 300])
def test_expand_score_pq_over_m_and_c(dev, m, C):
    """m from 1 to 192 (one or more 32-byte code chunks, 16-byte loads
    where m % 16 == 0; three tables a block up to m = 75, two up to 113,
    one above); C from one candidate to more than a block's 256 threads."""
    from repro_torch.kernels import expand_score as es

    codes, cb, idx, q = pq_case(dev, 400, m, 2, 5, C, seed=7 * m + C)
    lut = es.pq_lut(cb, q)
    assert_bitwise([es.expand_score_pq_cuda(codes, cb, idx, q, lut=lut)],
                   [es.expand_score_pq_torch(codes, cb, idx, q, lut=lut)])


@pytest.mark.parametrize("m", [3, 16, 17, 32])
@pytest.mark.parametrize("offset", [1, 2, 3, 8])
def test_expand_score_pq_unaligned_code_rows(dev, m, offset):
    """Codes and tables behind views that start past a 16-byte boundary:
    code rows through aligned words and a funnel shift, tables copied 4
    bytes at a time."""
    from repro_torch.kernels import expand_score as es

    codes, cb, idx, q = pq_case(dev, 300, m, 2, 9, 70, seed=m + offset)
    cbuf = torch.zeros(codes.numel() + 16, dtype=torch.uint8, device=dev)
    cview = cbuf[offset : offset + codes.numel()].view(codes.shape)
    cview.copy_(codes)
    lut = es.pq_lut(cb, q)
    lbuf = torch.zeros(lut.numel() + 4, device=dev)
    lview = lbuf[offset % 4 : offset % 4 + lut.numel()].view(lut.shape)
    lview.copy_(lut)
    assert cview.data_ptr() % 16 == offset
    assert_bitwise([es.expand_score_pq_cuda(cview, cb, idx, q, lut=lview)],
                   [es.expand_score_pq_torch(codes, cb, idx, q, lut=lut)])


@pytest.mark.parametrize("m,B", [(16, 2), (16, 5000), (192, 3), (192, 1500)])
def test_expand_score_pq_persistent_blocks(dev, m, B):
    """B below the number of resident blocks (some blocks would have no
    query) and far above it (each block walks many queries through its
    table ring); m = 192 keeps one table a block."""
    from repro_torch.kernels import expand_score as es

    codes, cb, idx, q = pq_case(dev, 500, m, 1, B, 40, seed=m + B)
    lut = es.pq_lut(cb, q)
    assert_bitwise([es.expand_score_pq_cuda(codes, cb, idx, q, lut=lut)],
                   [es.expand_score_pq_torch(codes, cb, idx, q, lut=lut)])


def test_expand_score_pq_refuses_tables_above_shared_memory(dev):
    from repro_torch.kernels import expand_score as es

    codes, cb, idx, q = pq_case(dev, 20, 250, 1, 2, 3)
    with pytest.raises(ValueError):
        es.expand_score_pq_cuda(codes, cb, idx, q)


def test_quantized_kernels_main_shape(dev):
    """n = 1M, d = 128, B = 10,000, C = 256, 20 % masked: the shape of
    chip_smoke.py's phase 2."""
    from repro_torch.kernels import expand_score as es

    n, d, B, C = 1_000_000, 128, 10_000, 256
    case = int8_case(dev, n, d, B, C, seed=11)
    assert_bitwise([es.expand_score_q_cuda(*case)], [es.expand_score_q_torch(*case)])
    codes, cb, idx, q = pq_case(dev, n, 16, 8, B, C, seed=12)
    lut = es.pq_lut(cb, q)
    assert_bitwise([es.expand_score_pq_cuda(codes, cb, idx, q, lut=lut)],
                   [es.expand_score_pq_torch(codes, cb, idx, q, lut=lut)])
    x, idx, q = expand_case(dev, n, d, B, C, seed=13)
    x = x.to(torch.bfloat16)
    assert_bitwise([ops.expand_score(x, idx, q, backend="cuda")],
                   [ops.expand_score(x, idx, q, backend="torch")])


def beam_case(dev, B, E, L, *, seed=0):
    rng = np.random.default_rng(seed)
    pool = [0.25, 0.5, 1.0, 2.0]
    bd = rng.choice(pool, size=(B, E)).astype(np.float32)
    bd[rng.uniform(size=(B, E)) < 0.3] = np.inf
    bp = (rng.integers(0, 500, (B, E)) << 1).astype(np.int32)
    bp = np.where(np.isfinite(bd), bp, PAD_PAYLOAD).astype(np.int32)
    o = np.lexsort((bp, bd), axis=-1)
    bd = np.take_along_axis(bd, o, -1)
    bp = np.take_along_axis(bp, o, -1)
    cd = rng.choice(pool + [np.inf], size=(B, L)).astype(np.float32)
    cp = np.where(np.isfinite(cd), rng.integers(0, 500, (B, L)) << 1,
                  PAD_PAYLOAD).astype(np.int32)
    return tuple(torch.as_tensor(a, device=dev) for a in (bd, bp, cd, cp))


@pytest.mark.parametrize("B,E,L", [(1, 8, 8), (5, 16, 48), (9, 64, 128), (3, 64, 5),
                                   (2, 8, 200), (7, 32, 32), (4, 1, 3), (6, 128, 512)])
def test_beam_merge_matches_plain(dev, B, E, L):
    case = beam_case(dev, B, E, L, seed=B * 100 + E + L)
    assert_bitwise(ops.beam_merge(*case, backend="cuda"), ops.beam_merge(*case, backend="torch"))


def test_beam_merge_nan_and_signed_zero(dev):
    """Any input: the kernel runs the reference's per-element rule, so even
    NaN keys and -0.0 come out where the plain network puts them."""
    bd, bp, cd, cp = beam_case(dev, 8, 16, 40, seed=5)
    cd = cd.clone()
    cd[:, ::7] = float("nan")
    cd[:, 3::11] = -0.0
    assert_bitwise(ops.beam_merge(bd, bp, cd, cp, backend="cuda"),
                   ops.beam_merge(bd, bp, cd, cp, backend="torch"))


def test_beam_merge_main_shape(dev):
    case = beam_case(dev, 10_000, 64, 256, seed=3)
    assert_bitwise(ops.beam_merge(*case, backend="cuda"), ops.beam_merge(*case, backend="torch"))


def beam_edge_case(dev, B, E, L, *, seed=0, edge=False):
    """``beam_case`` over more keys; with ``edge``: NaN and -0.0 in beam and
    candidates, beam entries ``(inf, id << 1)``, an unsorted beam row, and
    every third candidate row all pads."""
    rng = np.random.default_rng(seed)
    bd, bp, cd, cp = (t.cpu().numpy().copy() for t in beam_case(dev, B, E, L, seed=seed))
    if edge:
        for a in (bd, cd):
            a[rng.uniform(size=a.shape) < 0.1] = np.nan
            a[rng.uniform(size=a.shape) < 0.1] = -0.0
            a[rng.uniform(size=a.shape) < 0.05] = 0.0
        inf_ids = rng.uniform(size=bd.shape) < 0.2
        bd[inf_ids] = np.inf
        bp[inf_ids] = rng.integers(0, 500, int(inf_ids.sum())) << 1
        bd[0] = rng.permutation(bd[0])
        cd[::3] = np.inf
        cp[::3] = PAD_PAYLOAD
    return tuple(torch.as_tensor(a, device=dev) for a in (bd, bp, cd, cp))


# Both sides of each boundary of the kernel's layout (N = max(L, E)): one key
# a lane (N <= 32) or more; one warp a row (N <= 256) or 2, 4, 8, 16 warps
# with strides >= 256 through shared memory (N = 4096 above 48 KiB of it);
# E below the keys a lane; the reversal across warps (E > 256); L < E; L_in
# not a multiple of 4 (scalar loads) beside multiples (16-byte loads).
@pytest.mark.parametrize("E,L", [(8, 31), (8, 33), (16, 5), (2, 101), (4, 257), (64, 255),
                                 (64, 256), (64, 257), (64, 1023), (64, 2047), (64, 4093),
                                 (512, 301), (4096, 3), (1, 3), (1, 2047), (64, 3), (128, 7),
                                 (128, 2047), (128, 2048), (2048, 4095)])
@pytest.mark.parametrize("edge", [False, True])
def test_beam_merge_layout_boundaries(dev, E, L, edge):
    case = beam_edge_case(dev, 37, E, L, seed=E + L + edge, edge=edge)
    assert_bitwise(ops.beam_merge(*case, backend="cuda"), ops.beam_merge(*case, backend="torch"))


@pytest.mark.parametrize("E,L", [(64, 256), (64, 2048), (16, 40)])
def test_beam_merge_all_pad_candidates(dev, E, L):
    """Every candidate row all pads (finished queries): the kernel skips the
    sort, and the unsorted beam with NaN and (inf, id << 1) entries comes
    out as the network puts it."""
    rng = np.random.default_rng(E + L)
    bd = rng.choice([0.5, 1.0, np.nan, np.inf, -0.0, 0.0], size=(19, E)).astype(np.float32)
    bp = (rng.integers(0, 500, (19, E)) << 1).astype(np.int32)
    bp[:, ::4] = PAD_PAYLOAD
    cd = np.full((19, L), np.inf, np.float32)
    cp = np.full((19, L), PAD_PAYLOAD, np.int32)
    case = tuple(torch.as_tensor(a, device=dev) for a in (bd, bp, cd, cp))
    assert_bitwise(ops.beam_merge(*case, backend="cuda"), ops.beam_merge(*case, backend="torch"))


def test_beam_merge_unaligned_rows(dev):
    """Tensors whose data starts off a 16-byte boundary take the scalar loads."""
    B, E, L = 11, 64, 256
    case = beam_edge_case(dev, B, E, L, seed=9, edge=True)
    moved = []
    for t in case:
        flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)
        view = flat[1:].view(t.shape)
        view.copy_(t)
        moved.append(view)
    assert moved[0].data_ptr() % 16 != 0
    assert_bitwise(ops.beam_merge(*moved, backend="cuda"), ops.beam_merge(*case, backend="torch"))


def test_beam_merge_paper_degree_shape(dev):
    """The paper's degree 256 + 256 with W = 4: L = 2048, eight warps a row."""
    case = beam_edge_case(dev, 10_000, 64, 2048, seed=4)
    assert_bitwise(ops.beam_merge(*case, backend="cuda"), ops.beam_merge(*case, backend="torch"))


def test_beam_merge_rejects_non_power_of_two(dev):
    bd, bp, cd, cp = beam_case(dev, 2, 8, 8)
    with pytest.raises(ValueError):
        ops.beam_merge(bd[:, :6].contiguous(), bp[:, :6].contiguous(), cd, cp, backend="cuda")


def prune_case(dev, B, C, d, *, seed=0, point=False, grid=False, pad_frac=0.2, d_uc_max=None,
               spread=1.0):
    """``d_uc_max`` sets how far ``d(u, ·)`` reaches (small: few geometric
    witnesses; large, with a small ``spread`` of the vectors: every pair)."""
    rng = np.random.default_rng(seed)
    if grid:
        xs = rng.choice([0.0, 0.5, 1.0, 2.0], size=(B, C, d)).astype(np.float32)
        ends = rng.choice([0.0, 0.25, 0.5, 0.75, 1.0], size=(B, C, 2))
    else:
        xs = (spread * rng.normal(size=(B, C, d))).astype(np.float32)
        ends = rng.uniform(size=(B, C, 2))
    i_c = np.sort(ends, axis=-1).astype(np.float32)
    if point:
        i_c[..., 1] = i_c[..., 0]
    i_u = np.sort(rng.uniform(size=(B, 2)), axis=-1).astype(np.float32)
    hi = 4.0 * d if d_uc_max is None else d_uc_max
    d_uc = np.sort(rng.uniform(0.1 * hi / (4.0 * d), hi, size=(B, C)), axis=-1).astype(np.float32)
    valid = rng.uniform(size=(B, C)) >= pad_frac
    valid[: max(B // 10, 1)] = False                     # some all-pad rows
    d_uc[~valid] = np.inf
    overlap = np.maximum(i_u[:, None, 0], i_c[..., 0]) <= np.minimum(i_u[:, None, 1], i_c[..., 1])
    return tuple(torch.as_tensor(a, device=dev) for a in (i_u, xs, i_c, d_uc, valid, overlap))


@pytest.mark.parametrize("B,C,d", [(1, 8, 4), (5, 33, 16), (16, 96, 24), (3, 5, 2), (7, 130, 40)])
@pytest.mark.parametrize("alpha", [1.0, 1.2])
@pytest.mark.parametrize("unified", [True, False])
@pytest.mark.parametrize("point", [False, True])
def test_prune_sweep_matches_plain(dev, B, C, d, alpha, unified, point):
    case = prune_case(dev, B, C, d, seed=B * 1000 + C + d, point=point)
    kw = dict(m_if=8, m_is=8, alpha=alpha, unified=unified)
    assert_bitwise(ops.prune_sweep(*case, backend="cuda", **kw),
                   ops.prune_sweep(*case, backend="torch", **kw))


@pytest.mark.parametrize("C", [31, 32, 33, 64, 65, 97])
@pytest.mark.parametrize("kind", ["gaussian", "budgets", "all_witnessed"])
@pytest.mark.parametrize("alpha", [1.0, 1.2])
@pytest.mark.parametrize("unified", [True, False])
def test_prune_sweep_chunk_edges(dev, C, kind, alpha, unified):
    """The kernel scans in chunks of 32 candidates: C on both sides of the
    chunk edges; budgets that run out inside a chunk (m_if = 3, m_is = 1,
    and few geometric witnesses); rows where every candidate after the
    first is witnessed (near-equal vectors, d(u, ·) far above them)."""
    kw = dict(m_if=3, m_is=1) if kind == "budgets" else dict(m_if=C, m_is=C)
    extra = dict(budgets=dict(d_uc_max=0.5), all_witnessed=dict(d_uc_max=1e4, spread=1e-3))
    case = prune_case(dev, 9, C, 40, seed=C * 7 + len(kind), pad_frac=0.1,
                      **extra.get(kind, {}))
    kw.update(alpha=alpha, unified=unified)
    got = ops.prune_sweep(*case, backend="cuda", **kw)
    want = ops.prune_sweep(*case, backend="torch", **kw)
    assert_bitwise(got, want)
    status, rep_if = want[0].cpu().numpy(), want[1].cpu().numpy()
    valid = case[4].cpu().numpy()
    if kind == "budgets":        # the budget, not a witness, stops most rows
        assert ((status & 1).sum(axis=1) <= 3).all() and ((status >> 1 & 1).sum(axis=1) <= 1).all()
        assert ((status & 1).sum(axis=1) == 3).any()
    if kind == "all_witnessed" and not unified:
        first = valid.argmax(axis=1)
        for b in np.flatnonzero(valid.any(axis=1)):
            later = valid[b] & (np.arange(C) > first[b])
            assert (rep_if[b][later] == first[b]).all()


def test_prune_sweep_grid_ties(dev):
    case = prune_case(dev, 12, 24, 8, seed=7, grid=True)
    kw = dict(m_if=5, m_is=5, alpha=1.0, unified=True)
    assert_bitwise(ops.prune_sweep(*case, backend="cuda", **kw),
                   ops.prune_sweep(*case, backend="torch", **kw))


def test_prune_sweep_above_default_shared_memory(dev):
    """Rows too long to stage in shared memory are read through L2
    (build_exact at n = 7,000); C = 29,057, which the earlier kernel
    refused, keeps 131,312 bytes of state a block, past the 48 KB that
    needs no opt-in; past 51,536 candidates, where the 4.5 bytes a
    candidate of state do not fit, the wrapper refuses."""
    kw = dict(m_if=7000, m_is=7000, alpha=1.0, unified=True)
    for rows, C, d, seed in ((2, 7000, 4, 13), (1, 29_057, 1, 57)):
        case = prune_case(dev, rows, C, d, seed=seed)
        assert_bitwise(ops.prune_sweep(*case, backend="cuda", **kw),
                       ops.prune_sweep(*case, backend="torch", **kw))
    big = prune_case(dev, 1, 51_537, 1, seed=14)
    with pytest.raises(ValueError):
        ops.prune_sweep(*big, backend="cuda", **kw)


def test_prune_sweep_main_shape(dev):
    case = prune_case(dev, 1024, 96, 128, seed=11)
    kw = dict(m_if=32, m_is=32, alpha=1.0, unified=True)
    assert_bitwise(ops.prune_sweep(*case, backend="cuda", **kw),
                   ops.prune_sweep(*case, backend="torch", **kw))


@pytest.mark.parametrize("B,C", [(2048, 132), (256, 256)])
def test_prune_sweep_update_shapes(dev, B, C):
    """The update path's sweeps: the new rows' out-edges (C = 132 at the
    build CLI's defaults) and each repair block (C = P = 256)."""
    case = prune_case(dev, B, C, 128, seed=C)
    kw = dict(m_if=32, m_is=32, alpha=1.0, unified=True)
    assert_bitwise(ops.prune_sweep(*case, backend="cuda", **kw),
                   ops.prune_sweep(*case, backend="torch", **kw))


def test_expand_score_repair_pool_shape(dev):
    """The repair pool: 256 rows of M + 2M² = 8,256 candidates at M = 64,
    most of them deduped or dead (-1)."""
    x, idx, q = expand_case(dev, 200_000, 128, 256, 8256, seed=8)
    idx = torch.where(torch.rand(idx.shape, device=dev) < 0.7, -1, idx).contiguous()
    assert_bitwise([ops.expand_score(x, idx, q, backend="cuda")],
                   [ops.expand_score(x, idx, q, backend="torch")])


def update_case(dev, tag="f32"):
    """A small index on the card, the ids to delete and the rows to insert."""
    from repro_torch.core import UGConfig, UGIndex

    rng = np.random.default_rng(3)
    n, d = 2000, 32
    x = rng.normal(size=(n + 150, d)).astype(np.float32)
    ints = np.sort(rng.uniform(size=(n + 150, 2)), axis=1).astype(np.float32)
    cfg = UGConfig(ef_spatial=16, ef_attribute=32, max_edges_if=16, max_edges_is=16,
                   iterations=2, exact_spatial=True, block=512)
    idx = UGIndex.build(x[:n], ints[:n], cfg, device=dev)
    if tag != "f32":
        idx = idx.with_dtype(tag)
    dels = rng.choice(n, 200, replace=False).astype(np.int32)
    return idx, dels, (x[n:], ints[n:])


def assert_same_store(a, b):
    sa, sb = a.store, b.store
    tensors = lambda s: [s.nbrs, s.status, s.intervals, s.alive, s.free, s.plane.data] + (
        [] if s.rerank is None else [s.rerank.data])
    assert_bitwise(tensors(sa), tensors(sb))


@pytest.mark.parametrize("tag", ["f32", "int8", "pq"])
def test_delete_and_insert_cuda_equals_torch(dev, tag):
    """Delete with repair, then insert (slots reused, then growth), through
    the kernels and through their plain versions: the same store bits."""
    idx, dels, (new_x, new_iv) = update_case(dev, tag)
    out = {}
    for backend in ("cuda", "torch"):
        d = idx.delete(dels, backend=backend)
        i = d.insert(new_x, new_iv, backend=backend, search_backend=backend)
        g = i.insert(new_x[:100], new_iv[:100], backend=backend, search_backend=backend)
        out[backend] = (d, i, g)
    for a, b in zip(out["cuda"], out["torch"]):
        assert_same_store(a, b)
    # 150 rows into 200 freed slots, then 100 into the 50 left: 2,050 slots
    # needed, so the capacity grows to the next power of two
    assert out["cuda"][1].capacity == idx.capacity and out["cuda"][2].capacity == 4096


def test_update_memory_profile_on_the_card(dev):
    from repro_torch.core import update_memory_profile

    prof = update_memory_profile("cuda")
    assert not prof["quadratic_cc"] and not prof["gather_bcd"]


def scan_case(dev, nq, nx, d, *, seed=0, integer=False, dtype=torch.float32):
    """Queries, corpus and intervals for the two scan kernels.  Integer data
    repeats the first half of the corpus rows (exact ties); every fifth
    query window is [2, 3], which no object passes in either direction."""
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
    qi = np.concatenate([np.maximum(c - 0.35, 0), np.minimum(c + 0.35, 1)], axis=1)
    qi[::5] = (2.0, 3.0)
    t = lambda a, dt=torch.float32: torch.as_tensor(a, dtype=dt, device=dev)
    return t(q, dtype), t(x, dtype), t(oi), t(qi)


def assert_within_bound(q, x):
    """The kernel within ``(d + 4)·2⁻²³·(‖q‖² + ‖x‖²)`` of the plain
    version, elementwise (the 3×TF32 product sums in another order)."""
    from repro_torch.kernels.l2dist import tolerance

    got = ops.pairwise_sq_dist(q, x, backend="cuda")
    want = ops.pairwise_sq_dist(q, x, backend="torch")
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == torch.float32
    err = (got.double() - want.double()).abs()
    assert bool((err <= tolerance(q, x).double()).all())


def assert_topk_within_rule(case, got, want, is_filter):
    """The kernel's top-k within ``fused_scan.rule_violations`` of the
    plain version's (the 3×TF32 distances sum in another order)."""
    from repro_torch.kernels.fused_scan import rule_violations

    torch.cuda.synchronize()
    assert rule_violations(*case, is_filter=is_filter, got=got, want=want) == []


@pytest.mark.parametrize("nq,nx,d", [(3, 5, 7), (17, 33, 17), (130, 257, 96),
                                     (64, 4096, 128), (129, 1000, 200)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pairwise_sq_dist_matches_plain(dev, nq, nx, d, dtype):
    q, x, _, _ = scan_case(dev, nq, nx, d, seed=nq + nx + d, dtype=dtype)
    assert_within_bound(q, x)


@pytest.mark.parametrize("nq,nx", [(3, 5), (130, 257), (129, 1001), (256, 384)])
@pytest.mark.parametrize("d", [7, 96, 128, 200])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pairwise_sq_dist_integer_bitwise(dev, nq, nx, d, dtype):
    """|v| ≤ 8 integers: the TF32 remainders are 0 and every sum is exact,
    so the tensor-core product is bitwise the plain fold's."""
    rng = np.random.default_rng(nq * nx + d)
    q, x = (torch.as_tensor(rng.integers(-8, 9, (n, d)).astype(np.float32), device=dev).to(dtype)
            for n in (nq, nx))
    assert_bitwise([ops.pairwise_sq_dist(q, x, backend="cuda")],
                   [ops.pairwise_sq_dist(q, x, backend="torch")])


def test_pairwise_sq_dist_unaligned_rows(dev):
    """Row views that start off a 16-byte boundary take the plain staging
    path of the kernel."""
    q, x, _, _ = scan_case(dev, 40, 300, 32, seed=5)
    shifted = [torch.cat([t.new_zeros(1), t.flatten()])[1:].view(t.shape) for t in (q, x)]
    assert all(t.is_contiguous() and t.data_ptr() % 16 == 4 for t in shifted)
    assert_within_bound(*shifted)


@pytest.mark.parametrize("nq,nx,d", [(5, 100, 7), (13, 500, 17), (70, 999, 96),
                                     (65, 3000, 128), (4, 300, 200), (3, 40, 8)])
@pytest.mark.parametrize("k", [1, 10, 64])
@pytest.mark.parametrize("is_filter", [True, False])
@pytest.mark.parametrize("integer", [False, True])
def test_filtered_topk_matches_plain(dev, nq, nx, d, k, is_filter, integer):
    """Ragged shapes, k > nx (nx = 40, k = 64), all-excluded rows and, on
    integer data, exact ties between repeated rows: bitwise there, within
    the rule on Gaussian data."""
    case = scan_case(dev, nq, nx, d, seed=nq * nx + d, integer=integer)
    kw = dict(is_filter=is_filter, k=k)
    got = ops.filtered_topk(*case, backend="cuda", **kw)
    want = ops.filtered_topk(*case, backend="torch", **kw)
    torch.cuda.synchronize()
    if integer:
        assert_bitwise(got, want)
    else:
        assert_topk_within_rule(case, got, want, is_filter)
    assert bool((got[1][::5] == -1).all())


@pytest.mark.parametrize("k", [1, 10, 64, 256])
@pytest.mark.parametrize("is_filter", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_filtered_topk_integer_bitwise(dev, k, is_filter, dtype):
    """|v| ≤ 8 integers at d = 128: the TF32 remainders are 0 and every sum
    is exact, so values and ids are the plain version's, ties included."""
    rng = np.random.default_rng(k)
    q, x = (rng.integers(-8, 9, (m, 128)).astype(np.float32) for m in (130, 3000))
    x[1500:] = x[:1500]
    _, _, oi, qi = scan_case(dev, 130, 3000, 8, seed=k, integer=True)
    case = (torch.as_tensor(q, device=dev).to(dtype), torch.as_tensor(x, device=dev).to(dtype),
            oi, qi)
    kw = dict(is_filter=is_filter, k=k)
    assert_bitwise(ops.filtered_topk(*case, backend="cuda", **kw),
                   ops.filtered_topk(*case, backend="torch", **kw))


def test_filtered_topk_bf16_and_large_k(dev):
    case = scan_case(dev, 33, 2000, 24, seed=3, integer=True, dtype=torch.bfloat16)
    for k in (200, 256):
        assert_bitwise(ops.filtered_topk(*case, is_filter=False, k=k, backend="cuda"),
                       ops.filtered_topk(*case, is_filter=False, k=k, backend="torch"))
    with pytest.raises(ValueError):
        ops.filtered_topk(*case, is_filter=False, k=257, backend="cuda")


@pytest.mark.parametrize("is_filter", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_filtered_topk_large_k_gaussian(dev, is_filter, dtype):
    """k = 256 at d = 128 on Gaussian data: the longest lists."""
    case = scan_case(dev, 300, 20_000, 128, seed=256, dtype=dtype)
    kw = dict(is_filter=is_filter, k=256)
    assert_topk_within_rule(case, ops.filtered_topk(*case, backend="cuda", **kw),
                            ops.filtered_topk(*case, backend="torch", **kw), is_filter)


def test_filtered_topk_main_shape(dev):
    """1,000 queries against 200,000 rows at d = 128 (many corpus ranges a
    query tile, so the merge kernel folds many lists)."""
    case = scan_case(dev, 1000, 200_000, 128, seed=21)
    assert_topk_within_rule(case, ops.filtered_topk(*case, is_filter=True, k=10, backend="cuda"),
                            ops.filtered_topk(*case, is_filter=True, k=10, backend="torch"), True)


def test_build_exact_prune_backends_bitwise(dev):
    from repro_torch.core.exact import build_exact

    rng = np.random.default_rng(4)
    x = rng.normal(size=(300, 16)).astype(np.float32)
    ints = np.sort(rng.uniform(size=(300, 2)), axis=1).astype(np.float32)
    mask = rng.uniform(size=300) < 0.7
    for unified in (True, False):
        for node_mask in (None, mask):
            kw = dict(unified=unified, node_mask=node_mask, device=dev)
            g_cuda = build_exact(x, ints, backend="cuda", **kw)
            g_torch = build_exact(x, ints, backend="torch", **kw)
            assert_bitwise([g_cuda.nbrs, g_cuda.status], [g_torch.nbrs, g_torch.status])


def test_launch_counters_count_kernel_launches(dev):
    ops.reset_launches()
    x, idx, q = expand_case(dev, 100, 16, 4, 8)
    ops.expand_score(x, idx, q, backend="cuda")
    ops.expand_score(x, idx, q, backend="torch")
    ops.expand_score(x.to(torch.bfloat16), idx, q, backend="cuda")
    assert ops.launches["expand_score"] == 1 and ops.launches["expand_score_bf16"] == 1
    from repro_torch.core.store import VectorPlane

    for tag in ("int8", "pq"):
        plane = VectorPlane.encode(x, tag)
        ops.expand_score_plane(plane, idx, q, backend="cuda")
        ops.expand_score_plane(plane, idx, q, backend="torch")
        assert ops.launches[f"expand_score_{'q' if tag == 'int8' else 'pq'}"] == 1
    q, x, oi, qi = scan_case(dev, 5, 50, 8)
    for backend in ("cuda", "torch"):
        ops.pairwise_sq_dist(q, x, backend=backend)
        ops.filtered_topk(q, x, oi, qi, is_filter=True, k=3, backend=backend)
    ops.gather_sq_dist(x, idx[:, :2].clamp(max=49).contiguous(), q[:4].contiguous(),
                       backend="cuda")
    assert ops.launches["pairwise_sq_dist"] == 1 and ops.launches["filtered_topk"] == 1
    assert ops.launches["expand_score"] == 2


def test_cuda_backend_rejects_cpu_tensors():
    x = torch.zeros((4, 8))
    idx = torch.zeros((2, 3), dtype=torch.int32)
    with pytest.raises(ValueError):
        ops.expand_score(x, idx, torch.zeros((2, 8)), backend="cuda")


# ------------------------------------------------------------------ serving
@pytest.fixture
def card_index(dev):
    """A small UG index built on the card with the kernels."""
    from repro_torch.core import UGConfig, UGIndex

    rng = np.random.default_rng(21)
    x = rng.normal(size=(2000, 32)).astype(np.float32)
    ints = np.sort(rng.uniform(size=(2000, 2)), axis=1).astype(np.float32)
    cfg = UGConfig(ef_spatial=16, ef_attribute=32, max_edges_if=16, max_edges_is=16,
                   iterations=2, exact_spatial=True)
    return UGIndex.build(x, ints, cfg, device=dev)


def serve_queries(nq, d=32, seed=22):
    rng = np.random.default_rng(seed)
    qv = rng.normal(size=(nq, d)).astype(np.float32)
    c = rng.uniform(size=(nq, 1)).astype(np.float32)
    qi = np.concatenate([np.maximum(c - 0.3, 0), np.minimum(c + 0.3, 1)], axis=1)
    return qv, qi, [1 + i % 2 for i in range(nq)]          # FLAG_IF, FLAG_IS in turn


def padded_search(index, qv, qi, flags):
    from repro_torch.kernels.util import pad_rows
    from repro_torch.serve.engine import bucket_batch_size, pad_batch

    B = len(flags)
    Bp = bucket_batch_size(B)
    dev = index.device
    q, w = pad_batch(torch.as_tensor(qv, device=dev), torch.as_tensor(qi, device=dev), Bp)
    f = pad_rows(torch.tensor(flags, dtype=torch.int32, device=dev), Bp, 1)
    res = index.search_mixed(q, w, f, ef=64, k=10)
    return res.ids[:B].cpu().numpy(), res.dist[:B].cpu().numpy()


def test_threaded_runtime_on_the_card(dev, card_index):
    """Single-row requests through the threaded runtime with an upsert and a
    remove mid-stream (in that order, so no freed slot is reused): every
    reply equals a direct padded search on its pinned snapshot, bitwise; no
    removed id surfaces after the write; the pre-write index keeps its
    tensors."""
    from repro_torch.serve import RuntimeConfig, ServeEngine, ServeRuntime

    eng = ServeEngine()
    eng.attach_index(card_index)
    nbrs0 = card_index.store.nbrs.clone()
    qv, qi, flags = serve_queries(300)
    dead = np.arange(0, 200, 2, dtype=np.int32)
    rng = np.random.default_rng(23)
    new_x = rng.normal(size=(50, 32)).astype(np.float32)
    new_iv = np.sort(rng.uniform(size=(50, 2)), axis=1).astype(np.float32)
    with ServeRuntime(eng, RuntimeConfig(max_batch=32)) as rt:
        futs, writes = [], []
        for i in range(300):
            if i == 150:
                writes += [rt.submit_upsert(new_x, new_iv), rt.submit_remove(dead)]
            futs.append(rt.submit(qv[i], qi[i], flags[i], deadline=rt.clock() + 120.0))
        replies = [f.result(timeout=120) for f in futs]
        stats = rt.stats()
    assert [w.result(timeout=5) for w in writes] == [50, 100]
    assert stats["rejected"] == 0 and stats["writes"] == 2
    groups = {}
    for i, r in enumerate(replies):
        groups.setdefault(id(r.index), (r.index, []))[1].append(i)
    assert len(groups) == 2
    for index, sel in groups.values():
        ids, dist = padded_search(index, qv[sel], qi[sel], [flags[i] for i in sel])
        for j, i in enumerate(sel):
            assert np.array_equal(replies[i].ids, ids[j])
            assert np.array_equal(replies[i].dist.view(np.int32), dist[j].view(np.int32))
    post = [r.ids for r in replies[150:]]
    assert not np.isin(np.concatenate(post), dead).any()
    assert torch.equal(card_index.store.nbrs, nbrs0)


@pytest.mark.parametrize("B", [1, 13, 300])
def test_retrieve_mixed_pads_without_changing_answers(dev, card_index, B):
    from repro_torch.serve import ServeEngine

    eng = ServeEngine(index=card_index)
    qv, qi, flags = serve_queries(B, seed=24)
    got = eng.retrieve_mixed(None, qi, flags, q_v=qv)
    want = card_index.search_mixed(qv, qi, torch.tensor(flags, dtype=torch.int32, device=dev),
                                   ef=64, k=10)
    assert_bitwise([got.ids, got.dist, got.steps], [want.ids, want.dist, want.steps])
    assert got.iters == want.iters


def test_checkpoint_round_trip_on_the_card(dev, card_index, tmp_path):
    from repro_torch import ckpt

    m = card_index.delete(np.arange(0, 100, 3, dtype=np.int32))
    ckpt.save_index(tmp_path, 0, m)
    back = ckpt.restore_index(tmp_path, device=dev)
    assert back.device.type == "cuda"
    st, sb = m.store, back.store
    assert_bitwise([st.plane.data, st.intervals, st.nbrs, st.status, st.alive, st.free],
                   [sb.plane.data, sb.intervals, sb.nbrs, sb.status, sb.alive, sb.free])
    qv, qi, flags = serve_queries(64, seed=25)
    f = torch.tensor(flags, dtype=torch.int32, device=dev)
    a, b = m.search_mixed(qv, qi, f), back.search_mixed(qv, qi, f)
    assert_bitwise([a.ids, a.dist, a.steps], [b.ids, b.dist, b.steps])


# ------------------------------------------------------------ sharded index
@pytest.mark.parametrize("dtype,rerank", [("f32", False), ("int8", True)])
def test_sharded_build_and_search_cuda_equals_torch(dev, dtype, rerank):
    """A 4-shard index of 5,000 rows in one process, built and searched
    through the kernels and through their plain versions: the same graph,
    planes and answers, bitwise; the probes merge to the sharded answer."""
    from repro_torch.core import UGConfig
    from repro_torch.core.sharded import (
        build_sharded_store, make_shard_probe_fns, make_sharded_search_fn,
    )
    from repro_torch.launch.mesh import make_mesh

    rng = np.random.default_rng(31)
    n, d = 5000, 32
    x = rng.normal(size=(n, d)).astype(np.float32)
    ints = np.sort(rng.uniform(size=(n, 2)), axis=1).astype(np.float32)
    cfg = UGConfig(ef_spatial=16, ef_attribute=32, max_edges_if=16, max_edges_is=16,
                   iterations=2, exact_spatial=True, block=512)
    mesh = make_mesh((4,), ("data",), device=dev)
    qv, qi, flags = serve_queries(200)
    q = (torch.as_tensor(qv, device=dev), torch.as_tensor(qi, device=dev),
         torch.tensor(flags, dtype=torch.int32, device=dev))
    out = {}
    for backend in ("cuda", "torch"):
        sidx = build_sharded_store(mesh, x, ints, cfg, dtype=dtype, rerank=rerank,
                                   backend=backend)
        fn = make_sharded_search_fn(mesh, mixed=True, backend=backend, plane_tag=dtype,
                                    has_rerank=rerank)
        out[backend] = (sidx, fn(sidx, *q))
    (a, (ia, da)), (b, (ib, db)) = out["cuda"], out["torch"]
    tensors = lambda s: [s.store.nbrs, s.store.status, s.store.plane.data, s.global_ids]
    assert_bitwise(tensors(a), tensors(b))
    assert_bitwise([ia, da], [ib, db])
    probes = [p(*q) for p in make_shard_probe_fns(a, 4)]
    dist, order = torch.sort(torch.cat([p[1] for p in probes], 1), dim=1, stable=True)
    ids = torch.gather(torch.cat([p[0] for p in probes], 1), 1, order[:, :10])
    assert_bitwise([ids, dist[:, :10]], [ia, da])
