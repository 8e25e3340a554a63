"""Significance tests over seeds.

Port of `oovrec_tpu/cli/significance_test.py`: run a configuration once
per seed (`cli/quick_start.py:objective_function`, unsaved) and compare
two configurations' test metric over the same seeds with a paired t-test
(scipy's `ttest_rel`).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np


def run_seeds(config_dict: Dict[str, Any], seeds: List[int],
              metric: Optional[str] = None) -> List[float]:
    """The test value of `metric` (the first test metric when None) of one
    run per seed."""
    from oovrec_tpu_torch.cli.quick_start import objective_function

    values = []
    for seed in seeds:
        res = objective_function(config_dict=dict(config_dict, seed=seed), saved=False)
        tr = res["test_result"]
        key = (metric or next(iter(tr))).lower()
        values.append(float(tr[key]))
    return values


def significance_test(config_a: Dict[str, Any], config_b: Dict[str, Any],
                      seeds: Optional[List[int]] = None,
                      metric: Optional[str] = None) -> Dict[str, Any]:
    """Both configurations over `seeds` (2020-2024 by default) and the
    paired t-test of their values. → the values, their means, t and p."""
    from scipy import stats

    seeds = seeds or [2020, 2021, 2022, 2023, 2024]
    a = run_seeds(config_a, seeds, metric)
    b = run_seeds(config_b, seeds, metric)
    t, p = stats.ttest_rel(a, b)
    return {
        "a_values": a,
        "b_values": b,
        "a_mean": float(np.mean(a)),
        "b_mean": float(np.mean(b)),
        "t_statistic": float(t),
        "p_value": float(p),
    }
