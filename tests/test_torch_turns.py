"""The CPU-testable parts of ``repro_torch.bench.turns``: the all-pad row
test, the recorder of a search's merges and the trace split.  The turns
themselves need a card and two builds of the kernels."""
import numpy as np
import pytest
import torch

from repro_torch.bench import turns
from repro_torch.core import Semantics, UGConfig, UGIndex
from repro_torch.kernels import ops
from repro_torch.kernels.beam_merge import PAD_PAYLOAD


def test_all_pad_rows_reads_bits():
    inf = float("inf")
    d = torch.tensor([[inf, inf], [inf, inf], [inf, -inf], [inf, float("nan")], [inf, 1.0]])
    p = torch.tensor([[PAD_PAYLOAD] * 2, [PAD_PAYLOAD, 6], [PAD_PAYLOAD] * 2,
                      [PAD_PAYLOAD] * 2, [PAD_PAYLOAD] * 2], dtype=torch.int32)
    assert turns.all_pad_rows(d, p).tolist() == [True, False, False, False, False]


@pytest.fixture(scope="module")
def small_index():
    rng = np.random.default_rng(3)
    n, d = 300, 8
    x = rng.normal(size=(n, d)).astype(np.float32)
    ints = np.sort(rng.uniform(size=(n, 2)), axis=-1).astype(np.float32)
    cfg = UGConfig(ef_spatial=12, ef_attribute=24, max_edges_if=10, max_edges_is=10,
                   iterations=2, repair_width=8, exact_spatial=True, block=128)
    idx = UGIndex.build(x, ints, cfg, device="cpu")
    qv = rng.normal(size=(24, d)).astype(np.float32)
    c = rng.uniform(size=(24, 1)).astype(np.float32)
    qi = np.concatenate([np.maximum(c - 0.3, 0), np.minimum(c + 0.3, 1)], axis=1)
    sems = [[Semantics.IF, Semantics.IS, Semantics.RS, Semantics.RF][i % 4] for i in range(24)]
    return idx, (torch.as_tensor(qv), torch.as_tensor(qi), sems)


def test_recording_merges_keeps_inputs_and_changes_nothing(small_index):
    idx, (qv, qi, sems) = small_index
    kw = dict(ef=16, k=5, width=2)
    plain = idx.search_mixed(qv, qi, sems, **kw)
    merge = ops.beam_merge
    with turns.recording_merges((1, 2)) as (shares, kept):
        res = idx.search_mixed(qv, qi, sems, **kw)
    assert ops.beam_merge is merge
    assert res.iters == plain.iters and len(shares) == res.iters + 1   # + the entry merge
    assert torch.equal(res.ids, plain.ids) and torch.equal(res.dist, plain.dist)
    assert sorted(kept) == [1, 2]
    bd, bp, cd, cp = kept[1]
    assert bd.shape == (24, 16) and cd.shape == (24, 2 * idx.graph.max_degree)
    assert shares[1] == pytest.approx(float(turns.all_pad_rows(cd, cp).float().mean()))
    assert all(0.0 <= s <= 1.0 for s in shares)


def test_profile_split_counts_the_window():
    """Busy time is the union of device intervals inside the annotated span
    (stretched to the last kernel), split by kernel name."""
    ev = [
        dict(name="search_batch", cat="user_annotation", ts=100.0, dur=100.0),
        dict(name="void expand_score_kernel<float>", cat="kernel", ts=110.0, dur=10.0),
        dict(name="beam_merge_kernel<8, 8, false>", cat="kernel", ts=115.0, dur=10.0),
        dict(name="elementwise", cat="kernel", ts=150.0, dur=20.0),
        dict(name="Memcpy DtoH", cat="gpu_memcpy", ts=190.0, dur=20.0),
        dict(name="before", cat="kernel", ts=10.0, dur=5.0),
        dict(name="aten::_local_scalar_dense", cat="cpu_op", ts=180.0, dur=8.0),
        dict(name="aten::add", cat="cpu_op", ts=120.0, dur=3.0),
    ]
    out = turns.profile_split({"traceEvents": ev}, "search_batch", iters=2)
    assert out["wall_ms"] == pytest.approx(0.110)            # stretched to 210
    assert out["device_busy_ms"] == pytest.approx(0.055)     # 110-125, 150-170, 190-210
    assert out["device_idle_share"] == pytest.approx(0.5)
    assert out["per_iter_device_ms"] == pytest.approx(
        dict(scorer=0.005, beam_merge=0.005, other_kernels=0.010, memcpy_memset=0.010))
    assert out["launches"] == dict(scorer=1, beam_merge=1, other_kernels=1, memcpy_memset=1)
    assert out["host_syncs"] == 1 and out["per_iter_host_sync_ms"] == pytest.approx(0.004)
