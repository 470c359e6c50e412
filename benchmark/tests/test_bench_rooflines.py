"""The rooflines' work counts at small N against sums by hand."""

import torch

from benchmark.harness import inputs, peaks, spec
from benchmark.reference import p3m


def test_allpairs_counts():
    mod = spec.load_module("rooflines", "cuda_sample_fp32")
    wl = {"n": 1000, "integrator": "euler"}
    assert mod.bound_s_per_step(wl, {}, None) == 28 * 1000 * 999 / 2 / peaks.FP32_FLOPS
    wl = {"n": 1000, "integrator": "hermite"}
    assert mod.bound_s_per_step(wl, {}, None) == 120 * 1000 * 999 / 2 / peaks.FP32_FLOPS
    # the bounds at the cells' own sizes
    assert abs(mod.bound_s_per_step({"n": 135168, "integrator": "euler"}, {}, None)
               - 3.818e-3) < 1e-6
    assert abs(mod.bound_s_per_step({"n": 65536, "integrator": "hermite"}, {}, None)
               - 3.846e-3) < 1e-6
    mesh = spec.load_module("rooflines", "sharded_fp32_1m")
    assert abs(mesh.bound_s_per_step({"n": 2 ** 20, "integrator": "euler", "chips": 4}, {},
                                     None) - 57.4e-3) < 1e-4


def test_p3m_count():
    mod = spec.load_module("rooflines", "p3m_cic_1m")
    pos, _ = inputs.shell(2000, 1.54, 8.0, seed=4)
    p = torch.as_tensor(pos)
    pairs = p3m.near_pairs(p, grid=16)
    n, g = 2000, 16
    by_hand = (40 * pairs / peaks.FP32_FLOPS
               + (n * 16 + g ** 3 * 4 + (2 * g) ** 3 * 16 + 3 * g ** 3 * 4 + n * 28 + n * 64)
               / peaks.HBM_BYTES)
    got = mod.bound_s_per_step({"n": n}, {"pm_grid": g}, p)
    assert abs(got - by_hand) <= 1e-15
