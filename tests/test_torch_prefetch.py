"""The port's batch prefetch (`data/prefetch.py`) and its hook in the
trainer.

`PrefetchIterator` keeps the wrapped iterable's order and length, runs it
on another thread, and raises an exception of that thread on the
consumer side; `maybe_prefetch` engages at `worker` > 0 (queue depth
max(2, worker)), as the JAX package's does. Then a two-epoch `Trainer.fit`
with the OOV regime (the frozen OOV sub-epoch, its Bernoulli keep and the
simulator drawn on the consumer side) at `worker: 2` must equal the same
run at `worker: 0` bit for bit, losses, parameters and BatchNorm
statistics, with the batches assembled off the main thread: BPR
(pairwise, the negatives drawn in the thread) and DCNv2 (pointwise, with
its running statistics).
"""

import threading

import numpy as np
import pytest
import torch

from oovrec_tpu_torch.cli.quick_start import build_model_and_state
from oovrec_tpu_torch.config import Config
from oovrec_tpu_torch.data.prefetch import PrefetchIterator, maybe_prefetch
from oovrec_tpu_torch.data.utils import create_dataset, data_preparation
from oovrec_tpu_torch.train import Trainer
from oovrec_tpu_torch.utils.seeding import init_seed

from tests.test_torch_dataset import ASSETS

LOAD_COL = {"inter": ["user_id", "item_id", "rating", "timestamp", "is_new"],
            "user": ["user_id", "age", "gender"], "item": ["item_id", "price", "category"]}
OOV = dict(inductive_mapper="random", add_oov_buckets=True, n_user_oov_buckets=8,
           n_item_oov_buckets=8, train_oov=True, oov_only_epoch=True, oov_train_ratio=0.8,
           oov_feature_mask_rate=0.2, oov_freeze_embedding=True)
RUNS = {
    "BPR": dict(model="BPR", topk=[2, 5], valid_metric="MRR@2"),
    "DCNV2": dict(model="DCNV2", numerical_features=["age", "price"], threshold={"rating": 4},
                  metrics=["AUC", "LogLoss"], valid_metric="AUC", model_eval_type="ranking",
                  cross_layer_num=2, mlp_hidden_size=[16, 8], dropout_prob=0.0,
                  eval_args={"split": {"RS": [0.8, 0.1, 0.1]}, "order": "TO",
                             "group_by": None, "mode": "labeled"}),
}


def test_order_and_length_kept_on_another_thread():
    seen = []

    def items():
        for i in range(7):
            seen.append(threading.get_ident())
            yield i

    class Sized:
        def __len__(self):
            return 7

        def __iter__(self):
            return items()

    it = PrefetchIterator(Sized(), depth=2)
    assert len(it) == 7
    assert list(it) == list(range(7))
    assert set(seen) and threading.get_ident() not in seen
    assert list(PrefetchIterator([], depth=3)) == []


def test_an_error_in_the_thread_surfaces_on_the_consumer_side():
    def items():
        yield 1
        yield 2
        raise KeyError("batch assembly failed")

    got = []
    with pytest.raises(KeyError, match="batch assembly failed"):
        for x in PrefetchIterator(items()):
            got.append(x)
    assert got == [1, 2]


@pytest.mark.parametrize("worker,depth", [(0, None), (None, None), (1, 2), (2, 2), (5, 5)])
def test_worker_gate(worker, depth):
    loader = [1, 2, 3]
    out = maybe_prefetch(loader, {"worker": worker})
    if depth is None:
        assert out is loader
    else:
        assert isinstance(out, PrefetchIterator) and out._depth == depth
        assert list(out) == loader and len(out) == 3
    # the config's key, its default 0 where not given
    given = {} if worker is None else {"worker": worker}
    assert (maybe_prefetch(loader, Config(given)) is loader) == (depth is None)


def _fit(model, worker, tmp_path):
    cfg = Config(dict(OOV, **RUNS[model], dataset="toy-ind", data_path=ASSETS, load_col=LOAD_COL,
                      epochs=2, train_batch_size=8, embedding_size=8, device="cpu",
                      worker=worker, log_tensorboard=False, checkpoint_dir=str(tmp_path)))
    init_seed(int(cfg["seed"]), True)
    ds = create_dataset(cfg)
    train, valid, _ = data_preparation(cfg, ds)
    threads = set()
    make = train._make_batch

    def recording(*a, **kw):
        threads.add(threading.get_ident())
        return make(*a, **kw)

    train._make_batch = recording
    trainer = Trainer(cfg, build_model_and_state(cfg, ds))
    trainer.fit(train, valid, saved=False)
    return trainer, threads


@pytest.mark.parametrize("model", sorted(RUNS))
def test_fit_with_workers_equals_fit_without(model, tmp_path):
    a, threads_a = _fit(model, 0, tmp_path / "w0")
    b, threads_b = _fit(model, 2, tmp_path / "w2")
    assert threads_a == {threading.get_ident()}
    assert threads_b and threading.get_ident() not in threads_b
    assert a.oov_loss_dict and list(a.train_loss_dict) == [0, 1]
    assert a.train_loss_dict == b.train_loss_dict and a.oov_loss_dict == b.oov_loss_dict
    assert a.best_valid_score == b.best_valid_score
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert list(sa) == list(sb)
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    stats = [k for k in sa if k.endswith((".mean", ".var"))]
    assert bool(stats) == (model == "DCNV2")
    assert all(not np.array_equal(sa[k].numpy(), np.zeros_like(sa[k].numpy()))
               for k in stats if k.endswith(".mean"))
