"""Shared fixtures: small deterministic corpora for the paper-core tests.

Also makes ``hypothesis`` optional: when the real package is unavailable the
vendored fallback (tests/_hypothesis_fallback.py) is registered under the
same module name *before* test modules import it, so the property-based
suites stay collectable and executable in hermetic environments.
"""
import sys

try:  # pragma: no cover - depends on environment
    import hypothesis  # noqa: F401
except ImportError:  # register the minimal vendored fallback
    import _hypothesis_fallback  # tests/ is on sys.path (pytest rootdir)

    sys.modules["hypothesis"] = _hypothesis_fallback
    sys.modules["hypothesis.strategies"] = _hypothesis_fallback.strategies

import jax
import jax.numpy as jnp
import pytest

from repro.core import intervals as iv


def pytest_addoption(parser):
    parser.addoption(
        "--run-slow", action="store_true", default=False,
        help="include tests marked slow (the heaviest hypothesis suites, "
             "excluded from the default tier-1 run to stay in CI budget)",
    )


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "hermetic: property/parity suites the no-hypothesis CI job runs "
        "(selected by marker — never by a hardcoded file list)",
    )
    config.addinivalue_line(
        "markers",
        "slow: heaviest property suites; skipped by default, run with "
        "--run-slow (an explicit -m selection also includes them)",
    )
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA card (the port's kernels have no CPU mode); "
        "skips without one",
    )


def pytest_collection_modifyitems(config, items):
    # An explicit marker selection (-m hermetic, -m slow, ...) means the
    # caller chose their own slice — don't second-guess it.
    if config.getoption("--run-slow") or config.getoption("-m"):
        return
    skip = pytest.mark.skip(
        reason="slow suite: tier-2 by default, enable with --run-slow")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)


@pytest.fixture(scope="session")
def small_corpus():
    """(x, intervals) for exact-URNG scale tests (n=220, d=8)."""
    k1, k2 = jax.random.split(jax.random.key(0))
    n, d = 220, 8
    return jax.random.normal(k1, (n, d)), iv.sample_uniform_intervals(k2, n)


@pytest.fixture(scope="session")
def medium_corpus():
    """(x, intervals) for UG build tests (n=1500, d=16)."""
    k1, k2 = jax.random.split(jax.random.key(1))
    n, d = 1500, 16
    return jax.random.normal(k1, (n, d)), iv.sample_uniform_intervals(k2, n)


@pytest.fixture(scope="session")
def queries():
    """(q_v, q_intervals) — 40 queries with moderate windows (d=8)."""
    k1, k2 = jax.random.split(jax.random.key(2))
    nq = 40
    qv = jax.random.normal(k1, (nq, 8))
    c = jax.random.uniform(k2, (nq, 1))
    qi = jnp.concatenate([jnp.maximum(c - 0.3, 0), jnp.minimum(c + 0.3, 1)], axis=1)
    return qv, qi
