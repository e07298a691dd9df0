"""The port's copies of the host-search examples run and print what the
JAX package's examples print (both are host numpy, seeded)."""

from __future__ import annotations

import importlib.util
from pathlib import Path

import pytest

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def _main(name: str):
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main


@pytest.mark.parametrize("name", ["quickstart", "multi_weight_recsys"])
def test_example_matches_reference(name, capsys):
    _main(f"{name}_torch")()
    got = capsys.readouterr().out
    _main(name)()
    assert got == capsys.readouterr().out
    assert "avg overall ratio" in got


def test_serve_retrieval_example_runs_on_cpu(capsys):
    """The port's LM-to-retrieval example, with its own asserts (async
    answers bit-exact with sync; at least 75% of source docs found)."""
    out = _main("serve_retrieval_torch")(["--device", "cpu"])
    assert out["found"] >= int(0.75 * out["n_queries"])
    text = capsys.readouterr().out
    assert "bit-exact with sync" in text and text.rstrip().endswith("ok")


def test_serve_retrieval_service_matches_jax_on_jax_corpus():
    """On one corpus (the JAX example's ``embed_corpus`` output), the
    port's plan and ``RetrievalService`` (the example's ``plan_service``,
    on the CPU) give the JAX service's ids, stop levels and n_checked on
    the example's queries."""
    import numpy as np

    from repro.core.datagen import make_weight_set as jax_weights
    from repro.core.params import PlanConfig as JaxPlanConfig
    from repro.core.wlsh import WLSHIndex as JaxWLSHIndex
    from repro.serving import RetrievalService as JaxService
    from repro.serving import ServiceConfig as JaxConfig

    spec = importlib.util.spec_from_file_location(
        "example_serve_retrieval", EXAMPLES / "serve_retrieval.py")
    jex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jex)
    spec = importlib.util.spec_from_file_location(
        "example_serve_retrieval_torch", EXAMPLES / "serve_retrieval_torch.py")
    pex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(pex)

    n_docs, n_queries, k = 2_048, 24, 5
    corpus, _ = jex.embed_corpus(n_docs)
    d = corpus.shape[1]
    users, _, plan, svc = pex.plan_service(corpus, k, q_batch=8,
                                           device="cpu")
    jusers = jax_weights(size=pex.N_USERS, d=d, n_subset=3, n_subrange=10,
                         seed=7)
    np.testing.assert_array_equal(users, jusers)
    jhost = JaxWLSHIndex(corpus, jusers, JaxPlanConfig(
        p=2.0, c=3, n=n_docs, gamma_n=100.0), tau=500.0, v=d // 4,
        v_prime=d // 4, value_range=float(corpus.max()), seed=8)
    jplan = jhost.export_serving_plan()
    assert ([g.beta_group for g in plan.groups]
            == [g.beta_group for g in jplan.groups])
    jsvc = JaxService(jplan, corpus, cfg=JaxConfig(k=k, q_batch=8,
                                                   use_pallas=False))
    rng = np.random.default_rng(9)
    wids = rng.integers(0, pex.N_USERS, size=n_queries)
    doc_ids = rng.choice(n_docs, n_queries, replace=False)
    queries = corpus[doc_ids] + rng.normal(0, 0.01, (n_queries, d)).astype(
        np.float32)
    got, want = svc.query(queries, wids), jsvc.query(queries, wids)
    assert len(np.unique(want.group_ids)) == plan.n_groups > 1
    np.testing.assert_array_equal(got.group_ids, want.group_ids)
    np.testing.assert_array_equal(got.stop_levels, want.stop_levels)
    np.testing.assert_array_equal(got.n_checked, want.n_checked)
    np.testing.assert_array_equal(got.ids, want.ids)
    np.testing.assert_allclose(got.dists, want.dists, rtol=1e-6)
