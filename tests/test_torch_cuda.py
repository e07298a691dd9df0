"""CUDA kernels on the card (marker ``cuda``; skipped without a device).

Run on a machine with a CUDA card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The first test builds ``kernels/csrc/fused_query.cu`` with nvcc.  Each
kernel is held to its plain torch version on the same CUDA tensors:
histograms and the +inf mask exactly, finite scores to rtol 1e-5 (or the
p = 2 atol of the norms expansion).  ``chip_smoke.py`` repeats this at the
main path's shapes.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from repro_torch.kernels import fused_query, ref

from _torch_inputs import assert_scores_close, make_pass_inputs

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    fused_query.build()
    return torch.device("cuda")


def _tensors(shape, seed, dev):
    n, d, beta, q, c, L = shape
    arrs = make_pass_inputs(n, d, beta, q, c, L, seed)
    names = ("cp", "cq", "pts", "qs", "qw", "mu", "beta_q", "r_min", "stop")
    return {k: torch.from_numpy(a).to(dev) for k, a in zip(names, arrs)}


@pytest.mark.parametrize("p", [2.0, 1.0, 0.5])
@pytest.mark.parametrize("shape", [(1000, 24, 40, 11, 3, 8),
                                   (333, 70, 100, 3, 2, 12)], ids=str)
def test_kernels_match_plain_versions(dev, p, shape):
    n, _, _, _, c, L = shape
    t = _tensors(shape, 1, dev)
    args = [t[k] for k in ("cp", "pts", "cq", "qs", "qw", "mu", "beta_q")]
    kw = dict(boff=5, n_valid=n - 50, c=c, n_levels=L, p=p)
    row_ok = (5 + torch.arange(n, device=dev)) < n - 50
    fused_query.reset_launch_counts()
    hf, hg = fused_query.fused_query_hist(*args, t["r_min"], **kw)
    sc = fused_query.fused_query_scores(*args, t["stop"], **kw)
    torch.cuda.synchronize()
    assert fused_query.launch_counts == {"fused_query_hist": 1,
                                         "fused_query_scores": 1}
    rf, rg = ref.fused_query_hist_ref(*args, t["r_min"], row_ok, c=c,
                                      n_levels=L, p=p)
    rs = ref.fused_query_scores_ref(*args, t["stop"], row_ok, c=c,
                                    n_levels=L, p=p)
    assert torch.equal(hf, rf)
    assert torch.equal(hg, rg)
    assert_scores_close(sc.cpu().numpy(), rs.cpu().numpy(),
                        t["qs"].cpu().numpy(), t["qw"].cpu().numpy(),
                        t["pts"].cpu().numpy(), p)


def test_wrappers_check_their_inputs(dev):
    t = _tensors((300, 8, 16, 2, 3, 6), 2, dev)
    args = [t[k] for k in ("cp", "pts", "cq", "qs", "qw", "mu", "beta_q")]
    kw = dict(boff=0, n_valid=300, c=3, n_levels=6, p=2.0)
    with pytest.raises(TypeError):
        fused_query.fused_query_hist(args[0].float(), *args[1:],
                                     t["r_min"], **kw)
    with pytest.raises(ValueError):
        fused_query.fused_query_scores(*args[:6], args[6][:1], t["stop"],
                                       **kw)
    with pytest.raises(ValueError):
        fused_query.fused_query_scores(args[0].t().contiguous().t(),
                                       *args[1:], t["stop"], **kw)
    with pytest.raises(ValueError):
        fused_query.fused_query_hist(*args[:-1], args[-1].cpu(),
                                     t["r_min"], **kw)


def test_service_on_the_card_matches_the_cpu(dev):
    from repro_torch.core.datagen import make_dataset, make_weight_set
    from repro_torch.core.params import PlanConfig
    from repro_torch.core.wlsh import WLSHIndex
    from repro_torch.serving import RetrievalService, ServiceConfig

    data = make_dataset(n=2048, d=24, seed=3)
    weights = make_weight_set(size=8, d=24, n_subset=4, n_subrange=10,
                              seed=4)
    plan = WLSHIndex(data, weights, PlanConfig(p=2.0, c=3, n=2048),
                     tau=500.0, v=4, v_prime=4, seed=5).export_serving_plan()
    rng = np.random.default_rng(6)
    wids = rng.integers(0, 8, 32)
    qs = (data[rng.choice(2048, 32)] + rng.normal(0, 3, (32, 24))).astype(
        np.float32)
    out = [RetrievalService(plan, data, cfg=ServiceConfig(
        k=5, q_batch=8, device=d)).query(qs, wids) for d in ("cuda", "cpu")]
    np.testing.assert_array_equal(out[0].ids, out[1].ids)
    np.testing.assert_array_equal(out[0].stop_levels, out[1].stop_levels)
    np.testing.assert_array_equal(out[0].n_checked, out[1].n_checked)
    np.testing.assert_allclose(out[0].dists, out[1].dists, rtol=1e-6)
