"""`host_scan_steps` in the port's trainer against the JAX package's.

`_host_scan_k` gives JAX's K over a grid of flags, loader sizes, dynamic
negatives and `oov_debug_skip_train`. `Trainer.fit` with `host_scan_steps:
4` (groups of four batches stacked, one copy to the device, the dense step
through `train/cuda_graph.py`, which runs eagerly on the CPU) equals
`host_scan_steps: 1` bit for bit, a remainder group and a frozen OOV
sub-epoch included, for BPR (adam and sparse adam) and xDeepFM (with
dropout: the masks draw per step); and it equals the JAX trainer's K = 4
on toy-ind to 1e-5, from bridged weights at dropout 0.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import torch  # noqa: E402

from oovrec_tpu.train.trainer import Trainer as JaxTrainer  # noqa: E402
from oovrec_tpu_torch.train import Trainer  # noqa: E402
from oovrec_tpu_torch.train import trainer as ptrainer  # noqa: E402
from oovrec_tpu_torch.utils.jax_params import flax_from_state_dict  # noqa: E402

from tests.test_torch_trainer import _bpr_cfg, _flat, _setup, _xdfm_cfg  # noqa: E402


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _fresh_feature_caches():
    from oovrec_tpu.inductive import factory as jax_factory
    from oovrec_tpu_torch.inductive import factory

    for mod in (factory, jax_factory):
        mod._global_cache = mod.InductiveFeatureCache("unset")
    yield
    for mod in (factory, jax_factory):
        mod._global_cache = mod.InductiveFeatureCache("unset")


class _Loader:
    def __init__(self, n, dynamic=False):
        self.n, self.dynamic = n, dynamic

    def __len__(self):
        return self.n


class _Cfg(dict):
    def __getitem__(self, k):
        return self.get(k)


@pytest.mark.parametrize("flag", [False, 0, 1, None, "auto", 4, 64, 200, "8"])
def test_host_scan_k_matches_jax(flag):
    for n in (1, 7, 127, 128, 129, 1000):
        for dynamic in (False, True):
            for skip in (False, True):
                cfg = _Cfg(host_scan_steps=flag, oov_debug_skip_train=skip)
                loader = _Loader(n, dynamic)

                class Fake:
                    config = cfg

                want = JaxTrainer._host_scan_k(Fake(), loader)
                assert ptrainer.Trainer._host_scan_k(Fake(), loader) == want, (n, dynamic, skip)


CASES = {
    # 11 rows in batches of 2: a group of four and a remainder of two
    "bpr": (_bpr_cfg, dict(epochs=2, oov_freeze_embedding=True, train_batch_size=2)),
    "bpr-sparse-adam": (_bpr_cfg, dict(epochs=2, oov_freeze_embedding=True, train_batch_size=2,
                                       learner="sparse_adam", learning_rate=1e-2)),
    "xdeepfm-dropout": (_xdfm_cfg, dict(epochs=2, oov_freeze_embedding=True,
                                        dropout_prob=0.2)),
}


def _fit(make, over, tmp_path, k):
    s = _setup(make(tmp_path, **dict(over, host_scan_steps=k)))
    cfg, model, train, valid, _ = s["port"]
    trainer = Trainer(cfg, model)
    groups = []
    stack = ptrainer.stack_to_device

    def counted(batches, device):
        groups.append(len(batches))
        return stack(batches, device)

    ptrainer.stack_to_device = counted
    try:
        trainer.fit(train, valid, saved=False)
    finally:
        ptrainer.stack_to_device = stack
    return s, trainer, groups


@pytest.mark.parametrize("case", list(CASES))
def test_scan_of_four_equals_one_step_at_a_time(case, tmp_path):
    make, over = CASES[case]
    _, one, g1 = _fit(make, over, tmp_path, 1)
    _, four, g4 = _fit(make, over, tmp_path, 4)
    assert not g1 and g4 and set(g4) == {4}
    assert four._global_step == one._global_step > 4 * len(g4)  # remainders ran per step
    assert one.train_loss_dict == four.train_loss_dict
    assert one.oov_loss_dict == four.oov_loss_dict and one.oov_loss_dict
    for n, p in one.params.items():
        assert torch.equal(p, four.params[n]), n
    assert one.opt_state["count"] == four.opt_state["count"]
    for part in ("mu", "nu"):
        for n, t in one.opt_state[part].items():
            assert torch.equal(t, four.opt_state[part][n]), (part, n)


@pytest.mark.parametrize("case", ["bpr", "xdeepfm"])
def test_scan_of_four_matches_jax(case, tmp_path):
    """Both packages at `host_scan_steps: 4` from the same weights: epoch
    losses to 1e-5 relative, parameters to 1e-5."""
    make, over = CASES["xdeepfm-dropout" if case == "xdeepfm" else case]
    over = dict(over, dropout_prob=0.0) if case == "xdeepfm" else over
    s, pt, groups = _fit(make, over, tmp_path, 4)
    assert groups
    jcfg, jm, variables, estate, jtrain, jvalid, _ = _setup(
        make(tmp_path, host_scan_steps=4, **over))["jax"]
    assert JaxTrainer._host_scan_k(type("F", (), {"config": jcfg})(), jtrain) == 4
    jt = JaxTrainer(jcfg, jm, variables, dict(estate))
    jt.fit(jtrain, jvalid, saved=False)
    for got, want in ((pt.train_loss_dict, jt.train_loss_dict),
                      (pt.oov_loss_dict, jt.oov_loss_dict)):
        assert list(got) == list(want)
        for e in want:
            np.testing.assert_allclose(got[e], want[e], rtol=1e-5, err_msg=f"epoch {e}")
    got = _flat(flax_from_state_dict(pt.model.state_dict(), pt.model))
    want = _flat(jt.variables["params"])
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5, err_msg=k)
