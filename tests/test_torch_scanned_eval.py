"""The port's scanned eval (`device_eval`) against its per-batch eval and
against the JAX package's scanned eval.

`device_eval: true` gives the per-batch pass's metrics exactly, over the
full sort and the uni-N sampled protocol, with the chunks forced small by
`device_eval_max_elements` (several stacked copies a pass) and the full
sort re-blocked by `device_eval_score_elements`, the loader's blocking
restored afterwards. The metrics equal the JAX runner's scanned eval to
1e-9 on the same weights (the port's BPR crossed through the bridge), and
`_use_scanned_eval` gives the JAX gate's answer over loaders, flags, eval
types, metrics that need more than the hits, and user counts.
"""

import copy

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402

from oovrec_tpu.cli.quick_start import build_model_and_state as jax_build  # noqa: E402
from oovrec_tpu.config import Config as JaxConfig  # noqa: E402
from oovrec_tpu.data.dataset import Dataset as JaxDataset  # noqa: E402
from oovrec_tpu.data.utils import data_preparation as jax_prep  # noqa: E402
from oovrec_tpu.eval.collector import Collector as JaxCollector  # noqa: E402
from oovrec_tpu.eval.runner import EvalRunner as JaxEvalRunner  # noqa: E402
from oovrec_tpu_torch.cli.quick_start import build_model_and_state  # noqa: E402
from oovrec_tpu_torch.config import Config  # noqa: E402
from oovrec_tpu_torch.data.dataset import Dataset  # noqa: E402
from oovrec_tpu_torch.data.utils import data_preparation  # noqa: E402
from oovrec_tpu_torch.eval.collector import Collector  # noqa: E402
from oovrec_tpu_torch.eval.runner import EvalRunner  # noqa: E402
from oovrec_tpu_torch.utils.jax_params import flax_from_state_dict  # noqa: E402

from tests.test_torch_dataset import PAPER_SPLIT, SYNTH, SYNTH_LOAD_COL, TOY  # noqa: E402

# the tracked synth-ind corpus: 1,718 test users (>= auto's 1,024), 901 items
BASE = dict(SYNTH, load_col=SYNTH_LOAD_COL, model="BPR", embedding_size=8, topk=[1, 3, 5],
            valid_metric="MRR@3", device="cpu", log_tensorboard=False)
CASES = {
    "full": dict(BASE, eval_args=dict(PAPER_SPLIT, mode="full"), eval_batch_size=9010),
    "uni5": dict(BASE, eval_args=dict(PAPER_SPLIT, mode="uni5"), eval_batch_size=3000),
}
# small bounds: chunks of a few batches; the full sort re-blocked upward
# from 10 to 25 users a batch
SMALL = dict(device_eval_max_elements=20000, device_eval_score_elements=901 * 25)


def _port(cfg):
    """Fresh loaders (uni-N draws its negatives anew each pass) and the
    model, its weights from the config's seed."""
    pcfg = Config(copy.deepcopy(cfg))
    ds = Dataset(pcfg)
    return pcfg, data_preparation(pcfg, ds, process_index=0, process_count=1), \
        build_model_and_state(pcfg, ds)


def _eval(cfg, **over):
    pcfg, loaders, model = _port(dict(cfg, **over))
    return EvalRunner(model, pcfg).evaluate(loaders[2])


@pytest.mark.parametrize("case", list(CASES))
def test_scanned_eval_equals_per_batch(case, monkeypatch):
    cfg = CASES[case]
    scans = []
    stack_chunks = EvalRunner._stack_chunks

    def spied(self, batches):
        n = 0
        for chunk in stack_chunks(self, batches):
            n += 1
            yield chunk
        scans.append((n, getattr(batches, "users_per_batch", None)))

    monkeypatch.setattr(EvalRunner, "_stack_chunks", spied)
    want = _eval(cfg, device_eval=False)
    assert not scans
    for over in ({}, SMALL):
        pcfg, loaders, model = _port(dict(cfg, device_eval=True, **over))
        test = loaders[2]
        upb = getattr(test, "users_per_batch", None)
        got = EvalRunner(model, pcfg).evaluate(test)
        assert got == want, over
        n_chunks, blocked = scans.pop()
        assert getattr(test, "users_per_batch", None) == upb  # restored
        if over and case == "full":
            assert n_chunks > 1 and blocked > upb
        elif over:
            assert n_chunks > 1


@pytest.mark.parametrize("case", list(CASES))
def test_scanned_eval_matches_jax(case):
    cfg = dict(CASES[case], device_eval=True, **SMALL)
    pcfg, loaders, model = _port(cfg)
    got = EvalRunner(model, pcfg).evaluate(loaders[2])
    jcfg = JaxConfig(config_dict=copy.deepcopy(cfg))
    jds = JaxDataset(jcfg)
    jloaders = jax_prep(jcfg, jds)
    jm, variables, estate = jax_build(jcfg, jds)
    params = jax.tree_util.tree_map(jax.numpy.asarray, flax_from_state_dict(
        model.state_dict(), model))
    jr = JaxEvalRunner(jm, jcfg, estate=estate)
    assert jr._use_scanned_eval(jloaders[2], JaxCollector(jcfg))
    want = jr.evaluate(dict(variables, params=params), jloaders[2])
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-9, err_msg=k)


class _Runner:
    mesh = None

    def __init__(self, config, model, eval_type):
        self.config, self.model, self.eval_type = config, model, eval_type


@pytest.mark.parametrize("flag", [True, False, "auto"])
def test_use_scanned_eval_matches_jax(flag):
    """Full-sort, uni-N and labelled loaders; RANKING and VALUE; a metric
    that needs the ranked items; few users and 2,000 (auto's bound)."""
    from oovrec_tpu.utils.enums import EvaluatorType as JaxType
    from oovrec_tpu_torch.utils.enums import EvaluatorType

    seen = set()
    for case in ("full", "uni5", "labeled"):
        cfg = dict(CASES.get(case, BASE), device_eval=flag)
        if case == "labeled":
            cfg.update(TOY, model="xDeepFM", numerical_features=["age", "price"],
                       threshold={"rating": 4}, metrics=["AUC"], valid_metric="AUC",
                       eval_args={"mode": "labeled"})
        for metrics in (None, ["Recall", "ItemCoverage"]):
            over = {} if metrics is None else dict(metrics=metrics, valid_metric="Recall@3")
            pcfg, loaders, model = _port(dict(cfg, **over))
            jcfg = JaxConfig(config_dict=copy.deepcopy(dict(cfg, **over)))
            jloaders = jax_prep(jcfg, JaxDataset(jcfg))
            for n_users in (None, 2000):
                p, j = loaders[2], jloaders[2]
                if n_users and hasattr(p, "uid_list"):
                    p.uid_list = j.uid_list = np.arange(1, n_users + 1)
                for et, jet in ((EvaluatorType.RANKING, JaxType.RANKING),
                                (EvaluatorType.VALUE, JaxType.VALUE)):
                    want = JaxEvalRunner._use_scanned_eval(
                        _Runner(jcfg, model, jet), j, JaxCollector(jcfg))
                    got = EvalRunner._use_scanned_eval(
                        _Runner(pcfg, model, et), p, Collector(pcfg))
                    assert got == want, (case, metrics, n_users, et)
                    seen.add(want)
    assert seen == ({True, False} if flag is not False else {False})
