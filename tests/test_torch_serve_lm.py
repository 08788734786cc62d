"""``ServeEngine``'s LM half and the serve CLI against the reference, on the
CPU, on reduced qwen1.5-4b and, for the other families, reduced rwkv6,
zamba2 and qwen3-moe (float32; their constant init leaves redrawn as in
``tests/torch_towers.py``).

The reference's weights come from its own ``Model.init`` and are carried
across with ``params_from_numpy``; tokens and masks are made with numpy.

* ``embed`` equals the reference's within 1e-5, with and without a mask
  (float32 sums in another order; the output has unit norm).
* ``retrieve``/``retrieve_mixed``/``upsert`` given tokens equal the same
  calls given the port's own ``embed`` output, bit for bit.
* Greedy ``generate`` equals the reference's token for token (the prompts'
  seed was checked for near-ties: the smallest gap between the two best
  logits of any step is printed by the test's assertion message).
* Sampled ``generate`` draws from its own seeded generator: the same seed
  gives the same tokens.
* rwkv6, zamba2 and qwen3-moe: ``embed`` within 1e-5 of the reference's
  (1e-4 for MoE, whose capacity dispatch and combine add float32 sums in
  another order), greedy ``generate`` of 8 tokens token for token (a
  mismatch names the smallest top-2 logit gap of the run); for encdec
  both calls raise in both packages (the reference's ``Model.forward`` has
  no encdec entry and its ``init_decode_state`` wants ``(params, frames)``).
* ``launch/serve.main`` runs the reduced tower end to end on the CPU, for
  qwen1.5-4b, rwkv6 and zamba2.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as ref_registry
from repro.models.api import get_model as ref_get_model
from repro.serve import ServeEngine as RefEngine
from repro_torch.configs import registry
from repro_torch.core import Semantics, UGConfig, UGIndex
from repro_torch.core import intervals as iv
from repro_torch.launch import serve as serve_cli
from repro_torch.models import get_model, params_from_numpy
from repro_torch.serve import ServeEngine
from torch_towers import redraw_constant_leaves

ARCH = "qwen1.5-4b"
FAMILIES = {"rwkv6-1.6b": 1e-5, "zamba2-2.7b": 1e-5, "qwen3-moe-235b-a22b": 1e-4}
CYCLE = [Semantics.IF, Semantics.IS, Semantics.RS, Semantics.RF]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small shapes: torch's intra-op pool would only contend with the other
    test processes and the reference's XLA threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def engines():
    """The reference's engine and the port's, on the same weights."""
    rcfg = ref_registry.get_arch(ARCH).reduced
    rmodel = ref_get_model(rcfg)
    rparams = rmodel.init(jax.random.key(11))
    cfg = registry.get_arch(ARCH).reduced
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, rparams), device="cpu")
    return RefEngine(rmodel, rparams), ServeEngine(get_model(cfg), params)


def tokens(seed, n, s=16, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, (n, s)).astype(np.int32)


def test_embed_matches_reference(engines):
    ref, eng = engines
    toks = tokens(0, 6)
    mask = (np.random.default_rng(1).random(toks.shape) > 0.3).astype(np.float32)
    mask[2] = 0.0                                  # an all-masked row: the norm floor
    for m in (None, mask):
        got = eng.embed(toks, m)
        want = np.asarray(ref.embed(toks, None if m is None else mask))
        assert got.dtype == torch.float32 and got.shape == (6, 64)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    norms = eng.embed(toks).norm(dim=-1)
    assert torch.allclose(norms, torch.ones(6), atol=1e-5)


def test_tokens_in_equal_vectors_in(engines):
    _, eng = engines
    n = 120
    x = eng.embed(tokens(2, n))
    ints = iv.sample_uniform_intervals(torch.Generator().manual_seed(3), n)
    cfg = UGConfig(ef_spatial=12, ef_attribute=24, max_edges_if=10, max_edges_is=10,
                   iterations=1, repair_width=8, exact_spatial=True)
    eng = ServeEngine(eng.model, eng.params)
    eng.attach_index(UGIndex.build(x, ints, cfg, device="cpu"))
    qt = tokens(4, 10)
    qv = eng.embed(qt)
    qi = torch.tensor([[0.2, 0.8]] * 10)
    a = eng.retrieve(qt, qi, sem=Semantics.IS, ef=16, k=5)
    b = eng.retrieve(None, qi, sem=Semantics.IS, ef=16, k=5, q_v=qv)
    sems = [CYCLE[i % 4] for i in range(10)]
    c = eng.retrieve_mixed(qt, qi, sems, ef=16, k=5)
    d = eng.retrieve_mixed(None, qi, sems, ef=16, k=5, q_v=qv)
    for r, s in ((a, b), (c, d)):
        assert torch.equal(r.ids, s.ids) and torch.equal(r.dist.view(torch.int32),
                                                         s.dist.view(torch.int32))
        assert torch.equal(r.steps, s.steps)
    new_t, new_iv = tokens(5, 8), ints[:8]
    index = eng.index
    assert eng.upsert(new_t, new_iv) == 8
    by_tokens = eng.index.store
    eng.index = index
    eng.upsert(None, new_iv, x=eng.embed(new_t))
    assert torch.equal(by_tokens.plane.data.view(torch.int32),
                       eng.index.store.plane.data.view(torch.int32))
    assert torch.equal(by_tokens.nbrs, eng.index.store.nbrs)


def test_greedy_generate_matches_reference(engines):
    ref, eng = engines
    prompts = tokens(6, 3, s=5)
    got = eng.generate(prompts, 8)
    want = np.asarray(ref.generate(prompts, 8))
    assert got.dtype == torch.int32 and got.shape == (3, 8)
    # the smallest gap between the two best logits over the run: a near-tie
    # would let rounding flip an argmax (none at this seed)
    state = eng.model.init_decode_state(eng.params, 3, 13)
    seq = np.concatenate([prompts, got.numpy()], axis=1)
    gap = np.inf
    for i in range(12):
        state, logits = eng.model.decode_step(eng.params, state, torch.from_numpy(seq[:, i:i + 1]))
        if i >= 4:
            top2 = logits.topk(2, dim=-1).values
            gap = min(gap, float((top2[:, 0] - top2[:, 1]).min()))
    assert np.array_equal(got.numpy(), want), f"smallest top-2 logit gap {gap}"
    assert gap > 1e-4


def test_sampled_generate_is_seeded(engines):
    _, eng = engines
    prompts = tokens(7, 2, s=4)
    a = eng.generate(prompts, 6, temperature=0.8, seed=3)
    b = eng.generate(prompts, 6, temperature=0.8, seed=3)
    assert torch.equal(a, b) and a.shape == (2, 6)
    assert bool(((a >= 0) & (a < 512)).all())


def test_engine_without_a_model_or_with_another_family_raises(engines):
    _, eng = engines
    for call in (lambda e: e.embed(tokens(0, 1)), lambda e: e.generate(tokens(0, 1), 2)):
        with pytest.raises(ValueError, match="no model"):
            call(ServeEngine())
    other = ServeEngine(get_model(registry.get_arch("seamless-m4t-medium").reduced), eng.params)
    with pytest.raises(ValueError, match="encdec"):
        other.generate(tokens(0, 1), 2)


@pytest.fixture(scope="module")
def family_engines():
    """``get(arch)``: the reference's engine and the port's on the same
    weights (the reference's init, constant leaves redrawn), made once."""
    made = {}

    def get(arch):
        if arch not in made:
            rmodel = ref_get_model(ref_registry.get_arch(arch).reduced)
            rparams = redraw_constant_leaves(
                jax.tree.map(np.asarray, rmodel.init(jax.random.key(12))), 13)
            cfg = registry.get_arch(arch).reduced
            made[arch] = (RefEngine(rmodel, rparams),
                          ServeEngine(get_model(cfg), params_from_numpy(cfg, rparams,
                                                                        device="cpu")))
        return made[arch]

    return get


def top2_gap(eng, prompts, got) -> float:
    """The smallest gap between the two best logits over the generated
    steps of a greedy run: a near-tie would let rounding flip an argmax."""
    n, s = prompts.shape
    state = eng.model.init_decode_state(eng.params, n, s + got.shape[1])
    seq = np.concatenate([prompts, got.numpy()], axis=1)
    gap = np.inf
    for i in range(seq.shape[1] - 1):
        state, logits = eng.model.decode_step(eng.params, state, torch.from_numpy(seq[:, i:i + 1]))
        if i >= s - 1:
            top2 = logits.topk(2, dim=-1).values
            gap = min(gap, float((top2[:, 0] - top2[:, 1]).min()))
    return gap


@pytest.mark.parametrize("arch", sorted(FAMILIES))
def test_family_embed_matches_reference(family_engines, arch):
    ref, eng = family_engines(arch)
    toks = tokens(20, 5)
    mask = (np.random.default_rng(21).random(toks.shape) > 0.3).astype(np.float32)
    for m in (None, mask):
        got = eng.embed(toks, m)
        want = np.asarray(ref.embed(toks, None if m is None else mask))
        assert got.shape == (5, 64)
        np.testing.assert_allclose(got.numpy(), want, atol=FAMILIES[arch])
    assert torch.allclose(eng.embed(toks).norm(dim=-1), torch.ones(5), atol=1e-5)


@pytest.mark.parametrize("arch", sorted(FAMILIES))
def test_family_greedy_generate_matches_reference(family_engines, arch):
    ref, eng = family_engines(arch)
    prompts = tokens(22, 3, s=5)
    got = eng.generate(prompts, 8)
    want = np.asarray(ref.generate(prompts, 8))
    assert got.dtype == torch.int32 and got.shape == (3, 8)
    assert np.array_equal(got.numpy(), want), \
        f"{arch}: smallest top-2 logit gap {top2_gap(eng, prompts, got)}"


def test_encdec_embed_and_generate_raise_in_both_packages():
    arch = "seamless-m4t-medium"
    rmodel = ref_get_model(ref_registry.get_arch(arch).reduced)
    ref = RefEngine(rmodel, rmodel.init(jax.random.key(14)))
    cfg = registry.get_arch(arch).reduced
    eng = ServeEngine(get_model(cfg), get_model(cfg).init(torch.Generator().manual_seed(14)))
    toks = tokens(23, 2, s=4)
    with pytest.raises(KeyError):                 # Model.forward has no encdec entry
        ref.embed(toks)
    with pytest.raises((TypeError, ValueError)):  # init_decode_state unpacks (params, frames)
        ref.generate(toks, 2)
    with pytest.raises(ValueError, match="encdec"):
        eng.embed(toks)
    with pytest.raises(ValueError, match="encdec"):
        eng.generate(toks, 2)


def test_serve_cli_runs_the_reduced_tower(capsys):
    assert serve_cli.main(["--device", "cpu", "--docs", "300", "--queries", "16",
                           "--mixed"]) == 0
    out = capsys.readouterr().out
    assert "qwen1.5-4b: embedded 300 docs (d=64)" in out
    assert "mixed 4-semantics stream" in out
    assert out.count("recall@10") >= 5


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "zamba2-2.7b"])
def test_serve_cli_runs_the_other_families(capsys, arch):
    assert serve_cli.main(["--arch", arch, "--device", "cpu", "--docs", "300",
                           "--queries", "16", "--mixed"]) == 0
    out = capsys.readouterr().out
    assert f"{arch}: embedded 300 docs (d=64)" in out
    assert "mixed 4-semantics stream" in out and out.count("recall@10") >= 5


def test_serve_cli_stops_at_embed_for_encdec(capsys):
    """As the reference's CLI does: it names the encdec tower, then fails at
    the embed step (the process exits non-zero)."""
    with pytest.raises(ValueError, match="encdec"):
        serve_cli.main(["--arch", "seamless-m4t-medium", "--device", "cpu", "--docs", "20",
                        "--queries", "4"])
    assert "[serve] encdec tower: seamless-m4t-medium" in capsys.readouterr().out
