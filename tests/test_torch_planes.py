"""The port's bf16, int8 and pq vector planes and f32 rerank plane against
the reference, on the CPU.

Inputs are made with numpy from a seed and handed to both packages; the
reference runs through its ``xla`` twins.

* Kernels.  The int8 and bf16 kernels' per-thread order, bf16 widening
  and the pq kernel's code-byte loads, emulated in numpy, are the plain
  versions' bit for bit.  ``expand_score_q_torch`` equals ``expand_score_q_xla`` bitwise
  where the dequant is exact (integer codes, scale 1, zero 0) and to
  ``rtol=1e-5`` on Gaussian data (XLA sums over ``d`` in its own order and
  may contract the dequant into an FMA).  ``expand_score_pq_torch`` equals
  ``expand_score_pq_xla`` (called without ``lut=``, whose precomputed-LUT
  path changes bits in the reference itself) bitwise on integer queries and
  codebooks, and to ``rtol=1e-5`` on Gaussian data.
* Encoding.  int8 ``quantization_params`` and codes equal the reference's
  bitwise; pq codes under the same integer codebooks too.
* Search.  Over indexes the reference saved (int8 + rerank with exact
  dequant, pq + rerank with integer codebooks, bf16 on integer data, exact
  in bf16), the port returns the reference's ids, distances, step counts
  and iteration counts bit for bit, for frontier widths 1 and 4; each
  package reads the planes the other saved.
* Quality.  Port-trained planes on one graph keep the reference's own bars
  against the f32 plane: bf16 within 0.05, int8 + rerank within 0.02,
  pq + rerank within 0.05.
* Memory.  One fused step on every plane forms no ``(B, C, d)`` gather, no
  ``(·, C, C)`` tensor and no decoded ``(n, d)`` corpus; the legacy scorers
  do.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import Semantics as RefSem
from repro.core import UGConfig as RefConfig
from repro.core import UGIndex as RefIndex
from repro.core import store as ref_store
from repro.kernels import expand_score as ref_es
from repro_torch.core import Semantics, UGConfig, UGIndex, recall
from repro_torch.core import store as port_store
from repro_torch.core.search import search_step_memory_profile
from repro_torch.kernels import expand_score as port_es
from repro_torch.kernels import ops
from repro_torch.launch import build_index

CYCLE = [Semantics.IF, Semantics.IS, Semantics.RS, Semantics.RF]
EXACT_CFG = dict(ef_spatial=12, ef_attribute=24, max_edges_if=10, max_edges_is=10,
                 iterations=2, repair_width=8, exact_spatial=True, block=128)
PQ_M_EXACT = 4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The shapes here are tiny: torch's intra-op pool only contends with the
    other test processes and the reference's XLA threads (the build CLI test
    ran ~10x slower with it), so this module runs torch on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def bits(a) -> np.ndarray:
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def assert_bitwise(got, want):
    got, want = bits(got), bits(want)
    assert got.shape == want.shape
    assert np.array_equal(got, want)


def t(a) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(a))


def cand_ids(rng, n, B, C):
    idx = rng.integers(0, n, (B, C)).astype(np.int32)
    idx[rng.uniform(size=(B, C)) < 0.2] = -1
    idx[0] = -1                                              # an all-masked row
    return idx


def mixed_queries(rng, nq, d, *, lim=127):
    """A shuffled batch cycling IF/IS/RS/RF with integer query vectors."""
    qv = rng.integers(-lim, lim + 1, (nq, d)).astype(np.float32)
    c = rng.uniform(size=(nq, 1)).astype(np.float32)
    window = lambda h: np.concatenate([np.maximum(c - h, 0), np.minimum(c + h, 1)], axis=1)
    sems = [CYCLE[i % 4] for i in rng.permutation(nq)]
    half = {Semantics.IF: 0.3, Semantics.RF: 0.3, Semantics.IS: 0.3, Semantics.RS: 0.0}
    qi = np.stack([window(half[s])[i] for i, s in enumerate(sems)])
    return qv, qi.astype(np.float32), sems


# ------------------------------------------------------------------ kernels
@pytest.mark.parametrize("n,d,B,C", [(257, 19, 6, 23), (300, 40, 5, 64), (50, 8, 3, 1)])
@pytest.mark.parametrize("exact", [True, False])
def test_expand_score_q_matches_reference(n, d, B, C, exact):
    rng = np.random.default_rng(n + d)
    codes = rng.integers(-127, 128, (n, d)).astype(np.int8)
    if exact:
        scale, zero = np.ones(d, np.float32), np.zeros(d, np.float32)
        q = rng.integers(-127, 128, (B, d)).astype(np.float32)
    else:
        scale = rng.uniform(0.01, 0.1, d).astype(np.float32)
        zero = rng.normal(size=d).astype(np.float32)
        q = rng.normal(size=(B, d)).astype(np.float32)
    idx = cand_ids(rng, n, B, C)
    want = np.asarray(ref_es.expand_score_q_xla(*map(jnp.asarray, (codes, scale, zero, idx, q))))
    got = port_es.expand_score_q_torch(*map(t, (codes, scale, zero, idx, q)))
    assert np.isinf(got.numpy()[idx < 0]).all()
    if exact:
        assert_bitwise(got, want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)


def int8_codes_as_f32(codes: np.ndarray) -> np.ndarray:
    """The int8 kernel's conversion: the bits 0x4B000000 | (c ^ 0x80), the
    f32 2²³ + c + 128, less 2²³ + 128."""
    u = (codes.astype(np.uint8) ^ np.uint8(0x80)).astype(np.uint32) | np.uint32(0x4B000000)
    return u.view(np.float32) - np.float32(8388736.0)


def test_int8_code_bits_are_the_exact_value():
    codes = np.arange(-128, 128, dtype=np.int8)
    assert np.array_equal(int8_codes_as_f32(codes).view(np.int32),
                          codes.astype(np.float32).view(np.int32))


def bf16_bits_as_f32(bits16: np.ndarray) -> np.ndarray:
    """The bf16 kernel's widening: the element's 16 bits moved to the high
    half of a word, zeros below."""
    return (bits16.astype(np.uint32) << np.uint32(16)).view(np.float32)


def test_bf16_bits_widen_exactly():
    """All 65,536 bf16 patterns: the kernel's two widenings (``w << 16`` for
    the element in a word's low half, ``w & 0xffff0000`` for the high half,
    whatever the other half holds) give ``torch``'s bf16 -> f32 conversion
    bit for bit, NaN payloads included (no exception)."""
    pats = np.arange(1 << 16, dtype=np.uint32)
    other = np.random.default_rng(0).integers(0, 1 << 16, pats.shape).astype(np.uint32)
    sixteen = np.uint32(16)
    low = ((other << sixteen) | pats) << sixteen                   # element in the low half
    high = ((pats << sixteen) | other) & np.uint32(0xFFFF0000)     # element in the high half
    want = (torch.from_numpy(pats.astype(np.uint16).view(np.int16)).view(torch.bfloat16)
            .to(torch.float32).view(torch.int32).numpy())
    assert np.array_equal(low.view(np.int32), want)
    assert np.array_equal(high.view(np.int32), want)
    assert np.array_equal(bf16_bits_as_f32(pats.astype(np.uint16)).view(np.int32), want)


def thread_order(rows: np.ndarray, idx, q):
    """The order of the int8 and bf16 kernels in numpy, a candidate as one
    thread computes it from its decoded row ``rows[id]``: 32 lane sums
    (element e into sum e % 32, in order of e), then the butterfly's tree
    (s[l] + s[l + 16], then + 8, 4, 2, 1)."""
    B, C = idx.shape
    d = rows.shape[1]
    out = np.full((B, C), np.inf, dtype=np.float32)
    for b in range(B):
        for c in range(C):
            if idx[b, c] < 0:
                continue
            df = q[b] - rows[min(idx[b, c], len(rows) - 1)]
            s = np.zeros(32, dtype=np.float32)
            for e in range(d):
                s[e % 32] = s[e % 32] + df[e] * df[e]
            for w in (16, 8, 4, 2, 1):
                s[:w] = s[:w] + s[w : 2 * w]
            out[b, c] = s[0]
    return out


@pytest.mark.parametrize("plane", ["int8", "bf16"])
@pytest.mark.parametrize("d", [7, 100, 128, 129, 256])
def test_expand_score_q_thread_order_is_the_fixed_order(plane, d):
    """The int8 and bf16 kernels keep each candidate's 32 lane sums in one
    thread and end with a tree: that is the fixed lane order of the plain
    versions, bit for bit (Gaussian data, so any other order would show).
    Rows are decoded as the kernels decode them: int8 codes through their
    bits then ``x·scale + zero`` in two roundings, bf16 through its bits."""
    rng = np.random.default_rng(d)
    q = rng.normal(size=(3, d)).astype(np.float32)
    idx = rng.integers(-1, 40, (3, 9)).astype(np.int32)
    if plane == "int8":
        codes = rng.integers(-128, 128, (40, d)).astype(np.int8)
        scale = rng.uniform(0.01, 0.1, d).astype(np.float32)
        zero = rng.normal(size=d).astype(np.float32)
        rows = int8_codes_as_f32(codes) * scale + zero
        want = port_es.expand_score_q_torch(*map(torch.as_tensor, (codes, scale, zero, idx, q)))
    else:
        x = torch.as_tensor(rng.normal(size=(40, d)).astype(np.float32)).to(torch.bfloat16)
        rows = bf16_bits_as_f32(x.view(torch.int16).numpy().view(np.uint16))
        want = port_es.expand_score_torch(x, torch.as_tensor(idx), torch.as_tensor(q))
    assert_bitwise(want, thread_order(rows, idx, q))


def funnelshift_r(lo: int, hi: int, shift: int) -> int:
    return (((hi << 32) | lo) >> (shift & 31)) & 0xFFFFFFFF


def pq_kernel_codes(words: np.ndarray, start: int, m: int) -> list[int]:
    """The pq kernel's reads of the code row at byte ``start`` of an
    allocation (``words``: its little-endian 32-bit words, word 0 on a
    16-byte boundary): chunks of 32 codes, each as 16-byte loads where the
    row starts on a 16-byte boundary and m % 16 == 0, else as the aligned
    words that cover it, funnel shifted by the misalignment; code t of a
    chunk is byte t % 4 of word t // 4.  Asserts that every word read holds
    a byte of the row."""
    vec = start % 16 == 0 and m % 16 == 0
    got = []
    for j0 in range(0, m, 32):
        length = min(32, m - j0)
        p = start + j0
        if vec:
            w = []
            for i in range(2):
                if 16 * i < length:
                    assert p + 16 * i + 16 <= start + m
                    w += [int(v) for v in words[(p + 16 * i) // 4 : (p + 16 * i) // 4 + 4]]
                else:
                    w += [0] * 4
        else:
            base, mis = p // 4, p % 4
            nw = (mis + length + 3) // 4
            assert 4 * (base + nw - 1) < start + m and 4 * base + 3 >= start
            raw = [int(words[base + i]) if i < nw else 0 for i in range(9)]
            w = [funnelshift_r(raw[i], raw[i + 1], 8 * mis) for i in range(8)]
        got += [(w[t >> 2] >> (8 * (t & 3))) & 0xFF for t in range(length)]
    return got


@pytest.mark.parametrize("m", [1, 3, 16, 17, 32, 40])
def test_pq_code_bytes_from_words(m):
    """The pq kernel's code loads, emulated, return ``codes[row, j]`` at every
    row start modulo 16 (rows packed from a misaligned offset)."""
    rng = np.random.default_rng(m)
    n = 9
    codes = rng.integers(0, 256, (n, m)).astype(np.uint8)
    for offset in range(16):
        buf = np.zeros(((offset + n * m + 4 + 15) // 16) * 16, np.uint8)
        buf[offset : offset + n * m] = codes.reshape(-1)
        words = buf.view("<u4")
        for r in range(n):
            assert pq_kernel_codes(words, offset + r * m, m) == codes[r].tolist(), (offset, r)


@pytest.mark.parametrize("m,dsub", [(1, 8), (3, 4), (4, 2), (16, 1)])
@pytest.mark.parametrize("exact", [True, False])
def test_expand_score_pq_matches_reference(m, dsub, exact):
    rng = np.random.default_rng(m * 10 + dsub)
    n, B, C = 200, 5, 37
    codes = rng.integers(0, 256, (n, m)).astype(np.uint8)
    if exact:
        cb = rng.integers(-20, 21, (m, 256, dsub)).astype(np.float32)
        q = rng.integers(-20, 21, (B, m * dsub)).astype(np.float32)
    else:
        cb = rng.normal(size=(m, 256, dsub)).astype(np.float32)
        q = rng.normal(size=(B, m * dsub)).astype(np.float32)
    idx = cand_ids(rng, n, B, C)
    want = np.asarray(ref_es.expand_score_pq_xla(*map(jnp.asarray, (codes, cb, idx, q))))
    got = port_es.expand_score_pq_torch(*map(t, (codes, cb, idx, q)))
    lut = port_es.pq_lut(t(cb), t(q))
    assert_bitwise(port_es.expand_score_pq_torch(*map(t, (codes, cb, idx, q)), lut=lut), got)
    if exact:
        assert_bitwise(got, want)
        assert_bitwise(lut, ref_es.pq_lut(jnp.asarray(cb), jnp.asarray(q)))
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)


def test_pq_lut_rows_do_not_depend_on_the_batch():
    """The left-to-right fold over d/m makes each table row's bits
    independent of B: one query alone gets the rows it gets in a batch."""
    rng = np.random.default_rng(4)
    cb = t(rng.normal(size=(4, 256, 8)).astype(np.float32))
    q = t(rng.normal(size=(33, 32)).astype(np.float32))
    lut = port_es.pq_lut(cb, q)
    for i in (0, 7, 32):
        assert_bitwise(port_es.pq_lut(cb, q[i:i + 1])[0], lut[i])


def test_expand_score_bf16_matches_reference():
    """A bf16 plane through the f32 scorer: integer data is exact in bf16,
    so the port and the reference agree bitwise."""
    rng = np.random.default_rng(5)
    n, d, B, C = 120, 24, 4, 40
    x = t(rng.integers(-100, 101, (n, d)).astype(np.float32)).to(torch.bfloat16)
    q = rng.integers(-100, 101, (B, d)).astype(np.float32)
    idx = cand_ids(rng, n, B, C)
    x_ref = jnp.asarray(x.view(torch.int16).numpy()).view(jnp.bfloat16)
    want = ref_es.expand_score_xla(x_ref, jnp.asarray(idx), jnp.asarray(q))
    assert_bitwise(ops.expand_score(x, t(idx), t(q)), want)


@pytest.mark.parametrize("tag", ["f32", "bf16", "int8", "pq"])
def test_legacy_scorers_agree_with_fused(tag):
    """The legacy baselines (matmul identity) agree with the fused plain
    versions to rounding: rtol 1e-4, atol 1e-3, the reference's bar."""
    rng = np.random.default_rng(6)
    x = t(rng.normal(size=(150, 16)).astype(np.float32))
    plane = port_store.VectorPlane.encode(x, tag)
    q = t(rng.normal(size=(4, 16)).astype(np.float32))
    idx = t(cand_ids(rng, 150, 4, 30))
    fused = ops.expand_score_plane(plane, idx, q, backend="torch")
    legacy = ops.expand_score_plane(plane, idx, q, backend="legacy")
    fin = torch.isfinite(fused)
    assert torch.equal(fin, torch.isfinite(legacy))
    np.testing.assert_allclose(legacy[fin].numpy(), fused[fin].numpy(), rtol=1e-4, atol=1e-3)


# ----------------------------------------------------------------- encoding
def test_int8_encoding_matches_reference():
    rng = np.random.default_rng(7)
    x = (rng.normal(size=(500, 20)) * rng.uniform(0.1, 5, 20)).astype(np.float32)
    ref = ref_store.VectorPlane.encode(jnp.asarray(x), "int8")
    port = port_store.VectorPlane.encode(t(x), "int8")
    assert_bitwise(port.scale, ref.scale)
    assert_bitwise(port.zero, ref.zero)
    assert_bitwise(port.data, ref.data)
    assert_bitwise(port.encode_rows(t(x[:7])), port.data[:7])
    np.testing.assert_allclose(port.decode().numpy(), np.asarray(ref.decode()), rtol=1e-6, atol=1e-6)


def test_pq_encoding_matches_reference_under_the_same_codebooks():
    """Integer rows and codebooks: every centroid distance is exact, so the
    codes (first index on ties) and their decode equal the reference's."""
    rng = np.random.default_rng(8)
    x = rng.integers(-9, 10, (300, 12)).astype(np.float32)
    cb = rng.integers(-9, 10, (3, 256, 4)).astype(np.float32)
    ref = ref_store.VectorPlane.encode(jnp.asarray(x), "pq", jnp.asarray(cb))
    port = port_store.VectorPlane.encode(t(x), "pq", cb)
    assert_bitwise(port.data, ref.data)
    assert_bitwise(port.decode(), ref.decode())
    assert_bitwise(port.decode_rows(t(np.arange(5, 40))), ref.decode_rows(jnp.arange(5, 40)))


def test_pq_training_is_deterministic_and_chunked_encode_is_exact(monkeypatch):
    rng = np.random.default_rng(9)
    x = t(rng.normal(size=(700, 16)).astype(np.float32))
    cb = port_store.train_pq_codebooks(x, seed=3)
    assert cb.shape == (port_store.default_pq_m(16), port_store.PQ_K, 16 // port_store.default_pq_m(16))
    assert_bitwise(port_store.train_pq_codebooks(x, seed=3), cb)
    plane = port_store.VectorPlane.encode(x, "pq", cb)
    monkeypatch.setattr(port_store, "_PQ_ENCODE_ROWS", 64)
    assert_bitwise(plane.encode_rows(x), plane.data)


@pytest.mark.parametrize("d,m", [(1536, 192), (128, 16), (24, 3), (16, 2), (12, 1)])
def test_default_pq_m_matches_reference(d, m):
    assert port_store.default_pq_m(d) == ref_store.default_pq_m(d) == m


# ---------------------------------------------------- reference-saved indexes
def ref_plane_index(ref, x, tag):
    """The reference's index on another scan plane with exact arithmetic."""
    if tag == "pq":
        cb = np.random.default_rng(10).integers(
            -127, 128, (PQ_M_EXACT, 256, x.shape[1] // PQ_M_EXACT)).astype(np.float32)
        return ref.with_store(ref.store.replace(
            plane=ref_store.VectorPlane.encode(jnp.asarray(x), "pq", jnp.asarray(cb)),
            rerank=ref_store.VectorPlane.encode(jnp.asarray(x), "f32")))
    return ref.with_dtype(tag)


@pytest.fixture(scope="module")
def exact_planes(tmp_path_factory):
    """A reference build on integer vectors whose columns span exactly
    [-127, 127] (int8 scale 1, zero 0), saved on three scan planes."""
    rng = np.random.default_rng(0)
    n, d = 300, 8
    x = rng.integers(-127, 128, (n, d)).astype(np.float32)
    x[0], x[1] = -127, 127
    ints = np.sort(rng.uniform(size=(n, 2)), axis=-1).astype(np.float32)
    ref = RefIndex.build(jnp.asarray(x), jnp.asarray(ints), RefConfig(**EXACT_CFG))
    planes = {}
    for tag in ("bf16", "int8", "pq"):
        r = ref_plane_index(ref, x, tag)
        path = tmp_path_factory.mktemp(f"ref_{tag}")
        r.save(path)
        planes[tag] = (r, path)
    return x, ints, planes, mixed_queries(rng, 32, d)


def test_exact_planes_have_exact_dequant(exact_planes):
    _, _, planes, _ = exact_planes
    p = planes["int8"][0].store.plane
    assert np.all(np.asarray(p.scale) == 1.0) and np.all(np.asarray(p.zero) == 0.0)


@pytest.mark.parametrize("width", [1, 4])
@pytest.mark.parametrize("tag", ["bf16", "int8", "pq"])
def test_search_on_reference_saved_plane_bitwise(exact_planes, tag, width):
    _, _, planes, (qv, qi, sems) = exact_planes
    ref, path = planes[tag]
    port = UGIndex.load(path, device="cpu")
    assert port.dtype == tag
    assert (port.store.rerank is not None) == (tag != "bf16")
    want = ref.search_mixed(jnp.asarray(qv), jnp.asarray(qi), [RefSem(s.value) for s in sems],
                            ef=32, k=10, backend="xla", width=width)
    got = port.search_mixed(qv, qi, sems, ef=32, k=10, width=width)
    assert_bitwise(got.ids, want.ids)
    assert_bitwise(got.dist, want.dist)
    assert_bitwise(got.steps, want.steps)
    assert got.iters == int(want.iters)


@pytest.mark.parametrize("tag", ["bf16", "int8", "pq"])
def test_mixed_equals_per_semantics_on_planes(exact_planes, tag):
    _, _, planes, (qv, qi, sems) = exact_planes
    port = UGIndex.load(planes[tag][1], device="cpu")
    res = port.search_mixed(qv, qi, sems, ef=32, k=10, width=4)
    for s in CYCLE:
        sel = np.asarray([i for i, ss in enumerate(sems) if ss is s])
        one = port.search(qv[sel], qi[sel], sem=s, ef=32, k=10, width=4)
        assert_bitwise(res.ids[sel], one.ids)
        assert_bitwise(res.dist[sel], one.dist)
        assert_bitwise(res.steps[sel], one.steps)


def plane_arrays(plane) -> dict:
    """A plane's arrays as numpy (bf16 as its uint16 bits)."""
    out = {}
    for k in ("data", "scale", "zero", "codebooks"):
        a = getattr(plane, k)
        if a is None:
            continue
        if isinstance(a, torch.Tensor):
            a = a.view(torch.int16).numpy().view(np.uint16) if a.dtype == torch.bfloat16 else a.numpy()
        else:
            a = np.asarray(a)
            a = a.view(np.uint16) if a.dtype == jnp.bfloat16 else a
        out[k] = a
    return out


def assert_same_store(port_st, ref_st):
    assert port_st.plane.tag == ref_st.plane.tag
    p, r = plane_arrays(port_st.plane), plane_arrays(ref_st.plane)
    assert p.keys() == r.keys()
    for k in p:
        assert p[k].dtype == r[k].dtype, k
        assert_bitwise(p[k], r[k])
    assert (port_st.rerank is None) == (ref_st.rerank is None)
    if ref_st.rerank is not None:
        assert_bitwise(port_st.rerank.data, ref_st.rerank.data)
    assert_bitwise(port_st.nbrs, ref_st.nbrs)


@pytest.mark.parametrize("tag", ["bf16", "int8", "pq"])
def test_port_reads_reference_saved_plane(exact_planes, tag):
    _, _, planes, _ = exact_planes
    ref, path = planes[tag]
    assert_same_store(UGIndex.load(path, device="cpu").store, ref.store)


@pytest.mark.parametrize("tag", ["f32", "bf16", "int8", "pq"])
def test_reference_reads_port_saved_plane(exact_planes, tmp_path, tag):
    """The port saves its own (port-encoded) planes without re-encoding or
    casting them; the reference reads them as they are."""
    _, _, planes, _ = exact_planes
    port = UGIndex.load(planes["int8"][1], device="cpu").with_dtype(tag)
    port.save(tmp_path)
    ref = RefIndex.load(tmp_path)
    assert_same_store(port.store, ref.store)
    assert_same_store(UGIndex.load(tmp_path, device="cpu").store, ref.store)


# ----------------------------------------------------------------- quality
@pytest.fixture(scope="module")
def gaussian_index():
    rng = np.random.default_rng(3)
    n, d = 400, 16
    x = rng.normal(size=(n, d)).astype(np.float32)
    ints = np.sort(rng.uniform(size=(n, 2)), axis=-1).astype(np.float32)
    cfg = UGConfig(ef_spatial=16, ef_attribute=32, max_edges_if=12, max_edges_is=12,
                   iterations=2, repair_width=8, exact_spatial=True, block=256)
    idx = UGIndex.build(x, ints, cfg, device="cpu")
    nq = 48
    qv = rng.normal(size=(nq, d)).astype(np.float32)
    c = rng.uniform(size=(nq, 1))
    qi = np.concatenate([np.maximum(c - 0.3, 0), np.minimum(c + 0.3, 1)], axis=1)
    return idx, qv, qi.astype(np.float32)


@pytest.mark.parametrize("tag,rerank,bar", [("bf16", False, 0.05), ("int8", True, 0.02),
                                            ("pq", True, 0.05), ("int8", False, 0.1)])
def test_plane_recall_on_the_same_graph(gaussian_index, tag, rerank, bar):
    """Port-trained planes on the f32 plane's graph: recall@10 within the
    reference's bars (tests/test_store_planes.py) of the f32 plane's."""
    idx, qv, qi = gaussian_index
    other = idx.with_dtype(tag, rerank=rerank)
    assert other.dtype == tag and (other.store.rerank is not None) == rerank
    assert torch.equal(other.graph.nbrs, idx.graph.nbrs)
    for sem in (Semantics.IF, Semantics.IS, Semantics.RS):
        q = qi if sem is not Semantics.RS else np.repeat(qi[:, :1], 2, axis=1)
        gt = idx.ground_truth(qv, q, sem=sem, k=10)
        r_f32 = recall(idx.search(qv, q, sem=sem, ef=64, k=10), gt)
        r = recall(other.search(qv, q, sem=sem, ef=64, k=10), gt)
        assert r >= r_f32 - bar, (sem, r, r_f32)


def test_plane_bytes_per_vector(gaussian_index):
    idx = gaussian_index[0]
    n, d = idx.n, idx.store.dim
    m = port_store.default_pq_m(d)
    per = {tag: idx.with_dtype(tag).vector_memory_bytes() for tag in ("f32", "bf16", "int8", "pq")}
    assert per["f32"]["plane_bytes_per_vector"] == 4 * d and per["f32"]["rerank"] == 0
    assert per["bf16"]["plane_bytes_per_vector"] == 2 * d and per["bf16"]["rerank"] == 0
    assert per["int8"]["plane"] == n * d + 2 * 4 * d and per["int8"]["rerank"] == 4 * n * d
    assert per["pq"]["plane"] == n * m + 4 * 256 * d and per["pq"]["rerank"] == 4 * n * d


# ------------------------------------------------------------------- memory
@pytest.mark.parametrize("tag", ["f32", "bf16", "int8", "pq"])
def test_search_step_memory_profile(tag):
    fused = search_step_memory_profile("torch", dtype=tag)
    assert not fused["bcd_gather"] and not fused["cc_pairwise"] and not fused["decoded_nd"]
    legacy = search_step_memory_profile("legacy", dtype=tag)
    assert legacy["bcd_gather"] and legacy["cc_pairwise"]
    assert legacy["decoded_nd"] == (tag == "pq")
    assert legacy["peak_bytes"] > fused["peak_bytes"]


# ------------------------------------------------------------ entry points
@pytest.mark.parametrize("args", [["--dtype", "bf16"], ["--dtype", "int8", "--no-rerank"],
                                  ["--dtype", "pq"]])
def test_build_cli_planes(capsys, tmp_path, args):
    assert build_index.main(["--n", "200", "--dim", "16", "--device", "cpu",
                             "--out", str(tmp_path), *args]) == 0
    out = capsys.readouterr().out
    assert f"{args[1]} plane" in out
    assert ("+f32 rerank" in out) == (args[1] == "pq")
    assert UGIndex.load(tmp_path, device="cpu").dtype == args[1]


def test_plane_builds_need_a_card_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None runs on it")
    x = np.zeros((4, 2), np.float32)
    ints = np.tile(np.asarray([[0.0, 1.0]], np.float32), (4, 1))
    for tag in ("bf16", "int8", "pq"):
        with pytest.raises(RuntimeError):
            UGIndex.build(x, ints, dtype=tag)
