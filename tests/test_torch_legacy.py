"""The port's legacy A/B backends against the reference's, on the CPU.

Inputs are made once with numpy from a seed and given to both packages.

* The legacy prune sweep (materialise the ``(B, C, C)`` distance and Φ
  tensors, then scan) is the reference's ``prune_sweep_legacy`` bit for bit
  on integer-valued vectors, and the port's fused plain sweep bit for bit
  on any input.
* ``sweep_memory_profile`` flags a ``(·, C, C)`` tensor exactly where the
  reference's does; ``update_memory_profile('legacy')`` flags both the
  quadratic tensor and the ``(B, C, d)`` gather, as the reference's does.
* A ``prune_backend="legacy"`` build on integer data with
  ``exact_spatial=True`` is the reference's legacy build byte for byte, and
  the port's ``torch`` build.
* ``search_mixed(backend="legacy")`` gives the reference's ids, distances,
  step counts and iteration count bit for bit on a mixed IF/IS/RF/RS batch,
  on the f32 plane and on int8 + rerank with tombstones.
* An index the reference saved with ``prune_backend="legacy"`` loads as
  ``legacy`` and round-trips.
"""
import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import Semantics as RefSem
from repro.core import UGConfig as RefConfig
from repro.core import UGIndex as RefIndex
from repro.kernels import prune_sweep as ref_ps
from repro_torch.core import Semantics, UGConfig, UGIndex
from repro_torch.core.updates import update_memory_profile
from repro_torch.kernels import ops
from repro_torch.kernels import prune_sweep as port_ps

CYCLE = [Semantics.IF, Semantics.IS, Semantics.RS, Semantics.RF]
EXACT_CFG = dict(ef_spatial=12, ef_attribute=24, max_edges_if=10, max_edges_is=10,
                 iterations=2, repair_width=8, exact_spatial=True, block=128)
SEARCH = dict(ef=24, k=10)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The shapes here are tiny: torch's intra-op pool only contends with the
    other test processes and the reference's XLA threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def bits(a) -> np.ndarray:
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def assert_bitwise(got, want):
    got, want = bits(got), bits(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.array_equal(got, want)


# --------------------------------------------------------------- the sweep
def sweep_inputs(rng, B=24, C=40, d=8):
    """Integer-valued candidates (every distance exact), point intervals,
    pads and an all-pad row."""
    xs = rng.integers(-4, 5, (B, C, d)).astype(np.float32)
    i_c = np.sort(rng.uniform(size=(B, C, 2)), axis=-1).astype(np.float32)
    i_c[::5, :, 1] = i_c[::5, :, 0]
    i_u = np.sort(rng.uniform(size=(B, 2)), axis=-1).astype(np.float32)
    d_uc = np.sort(rng.integers(0, 200, (B, C)), axis=-1).astype(np.float32)
    valid = rng.uniform(size=(B, C)) >= 0.1
    valid[3] = False
    d_uc = np.where(valid, d_uc, np.inf).astype(np.float32)
    overlap = (np.maximum(i_u[:, None, 0], i_c[..., 0])
               <= np.minimum(i_u[:, None, 1], i_c[..., 1]))
    return i_u, xs, i_c, d_uc, valid, overlap


@pytest.mark.parametrize("unified", [True, False])
def test_legacy_sweep_bitwise_reference_and_fused(unified):
    args = sweep_inputs(np.random.default_rng(1))
    kw = dict(m_if=6, m_is=6, alpha=1.0, unified=unified)
    want = ref_ps.prune_sweep_legacy(*map(jnp.asarray, args), **kw)
    got = ops.prune_sweep(*map(torch.as_tensor, args), backend="legacy", **kw)
    fused = ops.prune_sweep(*map(torch.as_tensor, args), backend="torch", **kw)
    for g, w, f in zip(got, want, fused):
        assert_bitwise(g, np.asarray(w))
        assert_bitwise(g, f)


def test_legacy_sweep_materialises_the_row_distances():
    """``_materialize_d_cc`` is the fused sweep's distance row, stacked."""
    xs = torch.as_tensor(np.random.default_rng(2).normal(size=(3, 9, 5)).astype(np.float32))
    d_cc = port_ps._materialize_d_cc(xs)
    for t in range(9):
        assert_bitwise(d_cc[:, t], port_ps.cand_row_dist(xs, t))


@pytest.mark.parametrize("port_name,ref_name", [("legacy", "legacy"), ("torch", "xla")])
def test_sweep_memory_profile_flags_match_reference(port_name, ref_name):
    """Both packages flag the quadratic tensors exactly in the legacy sweep
    (the port's ``cuda`` row is held on the card); the peaks are each
    package's own and are not compared."""
    shape = dict(B=64, C=96, d=24)
    got = port_ps.sweep_memory_profile(port_name, **shape)
    want = ref_ps.sweep_memory_profile(ref_name, **shape)
    assert got["quadratic"] == want["quadratic"] == (port_name == "legacy")
    assert got["peak_bytes"] > 0


def test_sweep_memory_profile_at_the_build_block_allocates_nothing():
    """At the bench's block shape the profile runs on ``meta`` tensors: the
    legacy peak is a ``(B, C, C, 2)`` f32 broadcast, far above the fused
    sweep's, and no memory is touched."""
    legacy = port_ps.sweep_memory_profile("legacy", B=1024, C=96, d=24)
    fused = port_ps.sweep_memory_profile("torch", B=1024, C=96, d=24)
    assert legacy["quadratic"] and not fused["quadratic"]
    assert legacy["peak_bytes"] == 1024 * 96 * 96 * 2 * 4
    assert fused["peak_bytes"] < legacy["peak_bytes"] // 4


def test_update_memory_profile_legacy_flags_both():
    prof = update_memory_profile("legacy")
    assert prof["quadratic_cc"] and prof["gather_bcd"]
    assert prof["peak_bytes"] > update_memory_profile("torch")["peak_bytes"]


def test_legacy_is_not_a_kernel_policy_name():
    """``legacy`` is taken by the entry points; the kernel policy stays
    strict, and an unknown name still raises."""
    x = torch.zeros(4, 8)
    idx = torch.zeros(2, 3, dtype=torch.int32)
    q = torch.zeros(2, 8)
    assert ops.expand_score(x, idx, q, backend="legacy").shape == (2, 3)
    with pytest.raises(ValueError, match="unknown kernel backend"):
        ops.beam_merge(torch.zeros(2, 4), torch.zeros(2, 4, dtype=torch.int32),
                       torch.zeros(2, 4), torch.zeros(2, 4, dtype=torch.int32),
                       backend="legacy")
    with pytest.raises(ValueError, match="unknown kernel backend"):
        ops.prune_sweep(*map(torch.as_tensor, sweep_inputs(np.random.default_rng(0), 4, 4)),
                        m_if=2, m_is=2, backend="xla")


# ------------------------------------------------------- build and search
def mixed_queries(rng, nq, d):
    """A shuffled batch cycling IF/IS/RS/RF on integer vectors."""
    qv = rng.integers(-100, 101, (nq, d)).astype(np.float32)
    c = rng.uniform(size=(nq, 1)).astype(np.float32)
    sems = [CYCLE[i % 4] for i in rng.permutation(nq)]
    wide = np.concatenate([np.maximum(c - 0.3, 0), np.minimum(c + 0.3, 1)], axis=1)
    point = np.concatenate([c, c], axis=1)
    qi = np.where(np.asarray([s is Semantics.RS for s in sems])[:, None], point, wide)
    return qv, qi.astype(np.float32), sems


@pytest.fixture(scope="module")
def legacy_case(tmp_path_factory):
    """A reference legacy build on integer vectors whose columns span exactly
    [-127, 127] (int8 scale 1, zero 0), saved as built and, on int8 +
    rerank, after tombstoning 10 % of the rows."""
    rng = np.random.default_rng(0)
    n, d = 300, 8
    x = rng.integers(-127, 128, (n, d)).astype(np.float32)
    x[0], x[1] = -127, 127
    ints = np.sort(rng.uniform(size=(n, 2)), axis=-1).astype(np.float32)
    ref = RefIndex.build(jnp.asarray(x), jnp.asarray(ints),
                         RefConfig(**EXACT_CFG, prune_backend="legacy"))
    path = tmp_path_factory.mktemp("ref_legacy")
    ref.save(path)
    dels = rng.choice(n, size=n // 10, replace=False).astype(np.int32)
    ref_q = ref.with_dtype("int8").delete(jnp.asarray(dels), repair=False)
    path_q = tmp_path_factory.mktemp("ref_legacy_int8")
    ref_q.save(path_q)
    return x, ints, (ref, path), (ref_q, path_q), mixed_queries(rng, 32, d)


@pytest.mark.parametrize("backend", ["legacy", "torch"])
def test_legacy_build_is_the_reference_legacy_build(legacy_case, backend):
    x, ints, (ref, _), _, _ = legacy_case
    port = UGIndex.build(x, ints, UGConfig(**EXACT_CFG, prune_backend=backend), device="cpu")
    assert_bitwise(port.graph.nbrs, np.asarray(ref.graph.nbrs))
    assert_bitwise(port.graph.status, np.asarray(ref.graph.status))


@pytest.mark.parametrize("plane", ["f32", "int8_rerank_alive"])
def test_legacy_search_bitwise_reference(legacy_case, plane):
    _, _, f32_case, q_case, (qv, qi, sems) = legacy_case
    ref, path = f32_case if plane == "f32" else q_case
    port = UGIndex.load(path, device="cpu")
    assert port.dtype == ("f32" if plane == "f32" else "int8")
    assert (port.store.rerank is None) == (plane == "f32")
    assert (port.alive is None) == (plane == "f32")
    want = ref.search_mixed(jnp.asarray(qv), jnp.asarray(qi), [RefSem(s.value) for s in sems],
                            backend="legacy", **SEARCH)
    got = port.search_mixed(qv, qi, sems, backend="legacy", **SEARCH)
    for g, w in ((got.ids, want.ids), (got.dist, want.dist), (got.steps, want.steps)):
        assert_bitwise(g, np.asarray(w))
    assert got.iters == int(want.iters)
    if plane != "f32":                       # tombstones route but never surface
        dead = ~port.alive.numpy()
        assert not dead[got.ids.numpy()[got.ids.numpy() >= 0]].any()


def test_legacy_search_rows_are_independent(legacy_case):
    """A row's answer does not depend on the batch: a finished row stays
    frozen while slower rows go on."""
    _, _, (_, path), _, (qv, qi, sems) = legacy_case
    port = UGIndex.load(path, device="cpu")
    whole = port.search_mixed(qv, qi, sems, backend="legacy", **SEARCH)
    for i in (0, 7, 31):
        one = port.search_mixed(qv[i:i + 1], qi[i:i + 1], sems[i:i + 1], backend="legacy",
                                **SEARCH)
        assert_bitwise(one.ids[0], whole.ids[i])
        assert_bitwise(one.steps, whole.steps[i:i + 1])
    assert whole.iters == int(whole.steps.max())


def test_reference_legacy_backend_round_trips(legacy_case, tmp_path):
    _, _, (ref, path), _, _ = legacy_case
    port = UGIndex.load(path, device="cpu")
    assert port.config.prune_backend == "legacy"
    port.save(tmp_path)
    assert json.loads((tmp_path / "meta.json").read_text())["prune_backend"] == "legacy"
    assert RefIndex.load(tmp_path).config.prune_backend == "legacy"
    again = UGIndex.load(tmp_path, device="cpu")
    assert dataclasses.asdict(again.config) == dataclasses.asdict(port.config)
    assert_bitwise(again.graph.nbrs, np.asarray(ref.graph.nbrs))
