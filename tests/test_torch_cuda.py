"""Each CUDA kernel of the port against its plain PyTorch version, on the card.

Bitwise (floats compared as bit patterns), at small shapes and at the main
path's shapes.  Every test decides inside itself whether a card is present
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
                                     (1000, 128, 64, 256)])
def test_expand_score_q_matches_plain(dev, n, d, B, C):
    from repro_torch.kernels import expand_score as es

    case = int8_case(dev, n, d, B, C, seed=n + d)
    assert_bitwise([es.expand_score_q_cuda(*case)], [es.expand_score_q_torch(*case)])


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


def test_beam_merge_rejects_non_power_of_two(dev):
    bd, bp, cd, cp = beam_case(dev, 2, 8, 8)
    with pytest.raises(ValueError):
        ops.beam_merge(bd[:, :6].contiguous(), bp[:, :6].contiguous(), cd, cp, backend="cuda")


def prune_case(dev, B, C, d, *, seed=0, point=False, grid=False, pad_frac=0.2):
    rng = np.random.default_rng(seed)
    if grid:
        xs = rng.choice([0.0, 0.5, 1.0, 2.0], size=(B, C, d)).astype(np.float32)
        ends = rng.choice([0.0, 0.25, 0.5, 0.75, 1.0], size=(B, C, 2))
    else:
        xs = rng.normal(size=(B, C, d)).astype(np.float32)
        ends = rng.uniform(size=(B, C, 2))
    i_c = np.sort(ends, axis=-1).astype(np.float32)
    if point:
        i_c[..., 1] = i_c[..., 0]
    i_u = np.sort(rng.uniform(size=(B, 2)), axis=-1).astype(np.float32)
    d_uc = np.sort(rng.uniform(0.1, 4.0 * d, size=(B, C)), axis=-1).astype(np.float32)
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


def test_prune_sweep_grid_ties(dev):
    case = prune_case(dev, 12, 24, 8, seed=7, grid=True)
    kw = dict(m_if=5, m_is=5, alpha=1.0, unified=True)
    assert_bitwise(ops.prune_sweep(*case, backend="cuda", **kw),
                   ops.prune_sweep(*case, backend="torch", **kw))


def test_prune_sweep_main_shape(dev):
    case = prune_case(dev, 1024, 96, 128, seed=11)
    kw = dict(m_if=32, m_is=32, alpha=1.0, unified=True)
    assert_bitwise(ops.prune_sweep(*case, backend="cuda", **kw),
                   ops.prune_sweep(*case, backend="torch", **kw))


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


def test_cuda_backend_rejects_cpu_tensors():
    x = torch.zeros((4, 8))
    idx = torch.zeros((2, 3), dtype=torch.int32)
    with pytest.raises(ValueError):
        ops.expand_score(x, idx, torch.zeros((2, 8)), backend="cuda")
