"""The port's mesh step against the JAX package's `make_sharded_train_step`.

For one model of each loss class (a weighted row mean, CE over the items,
a ratio of sums over masked positions, S3Rec's pretraining with its
previous-row segment, the graph models' `emb_loss`, SGL's and NCL's
InfoNCE, SimpleX, the user-batch autoencoders, RaCT's batch-standardised
critic, ENMF, DirectAU's uniformity over row pairs, KGAT's KG block,
MCCLK's in-batch diagonal, Pop's parameter-only loss): the JAX package
builds the dataset, its loaders and the model of a toy-ind / toy-kg
config, takes the first training batch cut to an odd row count and runs
one sharded Adam step on a {data: 2} mesh of the conftest's CPU devices
(the batch padded by `place_batch`). The port, on 2 gloo ranks, builds
the same model from JAX's initial weights (`utils/jax_params.py`) and
runs one mesh step on its rows of the same batch. The loss agrees to 1e-5
relative and every parameter after the step to 1e-5 (Adam's first step
moves each entry by about the learning rate 1e-3 whatever the gradient's
size). Dropout is 0; the draws a loss cannot do without come from JAX:
S3Rec's mask, negatives and segment starts, SGL's edge masks, and the
normal and Bernoulli draws of MultiVAE and RaCT, each rank given its block
of rows of a per-row draw. LightGCN also runs on {data: 1, model: 2}
under `sharded_lookup: gspmd` with `row_shard_threshold` lowered, its
tables row-sharded on both sides.

The workers are this file run as a script (`tests/torch_mesh_harness.py:
run_ranks`); the parent holds the JAX side.
"""

import os
import pickle
import sys

import numpy as np
import pytest

from tests.torch_mesh_harness import ASSETS, join_group, leave_group, run_ranks

LR = 1e-3
LOAD_COL = {"inter": ["user_id", "item_id", "rating", "timestamp", "is_new"],
            "user": ["user_id", "age", "gender"], "item": ["item_id", "price", "category"]}
BASE = dict(dataset="toy-ind", data_path=ASSETS, load_col=LOAD_COL, train_batch_size=16,
            embedding_size=8, seed=7, learner="adam", learning_rate=LR,
            log_tensorboard=False, host_scan_steps=1, device_epoch=False, worker=0,
            eval_args={"split": {"RS": [0.8, 0.1, 0.1]}, "order": "TO", "group_by": "user",
                       "mode": "full"},
            train_neg_sample_args={"distribution": "uniform", "sample_num": 1, "alpha": 1.0,
                                   "dynamic": False, "candidate_num": 0})
SEQ = dict(BASE, MAX_ITEM_LIST_LENGTH=4, train_neg_sample_args=None)
KG = dict(BASE, dataset="toy-kg", load_col={"inter": ["user_id", "item_id", "rating",
                                                      "timestamp"]})
CASES = {
    "FM": dict(BASE, model="FM", numerical_features=["age", "price"],
               threshold={"rating": 4}, metrics=["AUC", "LogLoss"], valid_metric="AUC",
               eval_args=dict(BASE["eval_args"], group_by=None, mode="labeled")),
    "GRU4Rec": dict(SEQ, model="GRU4Rec", dropout_prob=0.0),
    "BERT4Rec": dict(SEQ, model="BERT4Rec", hidden_dropout_prob=0.0, attn_dropout_prob=0.0),
    "S3Rec": dict(SEQ, model="S3Rec", hidden_dropout_prob=0.0, selected_features=["category"]),
    "LightGCN": dict(BASE, model="LightGCN"),
    "SGL": dict(BASE, model="SGL"),
    "NCL": dict(BASE, model="NCL", num_clusters=4),
    "SimpleX": dict(BASE, model="SimpleX"),
    "MultiVAE": dict(BASE, model="MultiVAE", dropout_prob=0.0),
    "RaCT": dict(BASE, model="RaCT", dropout_prob=0.0, train_stage="finetune"),
    "ENMF": dict(BASE, model="ENMF", dropout_prob=0.0),
    "DirectAU": dict(BASE, model="DirectAU", train_neg_sample_args=None),
    "KGAT": dict(KG, model="KGAT", layers=[8, 8], kg_embedding_size=8, mess_dropout=0.0),
    "MCCLK": dict(KG, model="MCCLK", knn_k=3),
    "Pop": dict(BASE, model="Pop"),
    "LightGCN-sharded": dict(BASE, model="LightGCN", sharded_lookup="gspmd",
                             row_shard_threshold=4),
}
MESHES = {"LightGCN-sharded": (1, 2)}
DROPOUT_KEY = 5


def _odd(batch):
    """Each array's leading axis cut to an odd length."""
    out = {}
    for k, v in batch.items():
        v = np.asarray(v)
        out[k] = v[: len(v) - 1] if v.ndim >= 1 and len(v) % 2 == 0 else v
    return out


# ---------------------------------------------------------------- workers


class _BlockDraws:
    """The JAX draws (kind, array) handed out in order of kind, each as
    this rank's block of rows where the port asks for 1 / n_data of them."""

    def __init__(self, draws, rank, n_data):
        self.queue, self.rank, self.n = list(draws), rank, n_data

    def next(self, kind, shape):
        import torch

        i = next(j for j, (k, _a) in enumerate(self.queue) if k == kind)
        arr = self.queue.pop(i)[1]
        shape = tuple(shape)
        if arr.shape != shape:
            assert arr.shape[0] == shape[0] * self.n and arr.shape[1:] == shape[1:], (
                kind, arr.shape, shape)
            arr = arr[self.rank * shape[0]:(self.rank + 1) * shape[0]]
        return torch.from_numpy(np.asarray(arr, np.float32))


def _give_draws(model, case, draws, rank, n_data):
    """The JAX draws into the port's model: S3Rec's and SGL's through their
    draw methods, the autoencoders' through `RandomDraws`."""
    import torch

    if draws is None:
        return
    if case == "S3Rec":
        b = draws["start"].shape[0] // n_data
        block = {k: torch.from_numpy(v[rank * b:(rank + 1) * b]) for k, v in draws.items()}
        model.pretrain_draws = lambda batch: block
    elif case == "SGL":
        model.edge_masks = lambda: torch.from_numpy(draws)
    else:
        src = _BlockDraws(draws, rank, n_data)
        model.draws.keep = lambda p, shape, device: src.next("bernoulli", shape)
        model.draws.normal = lambda shape, device: src.next("normal", shape)


def _worker(rank, world, tmp):
    from oovrec_tpu_torch.cli.quick_start import build_model_and_state
    from oovrec_tpu_torch.config import Config
    from oovrec_tpu_torch.data.utils import create_dataset
    from oovrec_tpu_torch.parallel.mesh import clear_meshes, host_copy
    from oovrec_tpu_torch.train.trainer import Trainer
    from oovrec_tpu_torch.utils.jax_params import flax_from_state_dict, load_flax_params

    join_group(rank, world, tmp)
    with open(os.path.join(tmp, "payload.pkl"), "rb") as fh:
        payload = pickle.load(fh)
    out = {}
    for case, p in payload.items():
        clear_meshes()
        n_data, n_model = MESHES.get(case, (world, 1))
        cfg = dict(p["cfg"], device="cpu", checkpoint_dir=os.path.join(tmp, f"ck{rank}"))
        ds = create_dataset(Config(cfg))
        dense = build_model_and_state(Config(cfg), ds)
        model = build_model_and_state(Config(cfg), ds)
        load_flax_params(model, p["params"])
        tr = Trainer(Config(dict(cfg, use_mesh=True, mesh={"data": n_data, "model": n_model})),
                     model)
        _give_draws(model, case, p["draws"], tr.mesh.data_index, n_data)
        grads, step = {}, tr.optimizer.step

        def recorded(params, g, *a, **k):
            grads.update({n: v.detach().clone() for n, v in g.items()})
            return step(params, g, *a, **k)

        tr.optimizer.step = recorded
        loss = tr._apply_step(tr._to_device(p["batch"]))
        dense.load_state_dict(host_copy(model.state_dict(), model))
        out[case] = {"loss": float(loss),
                     "params": flax_from_state_dict(dense.state_dict(), dense),
                     "grads": None if n_model > 1 else flax_from_state_dict(grads, model)}
    leave_group(out, rank, tmp)


# ----------------------------------------------------------------- JAX side


class _WithDropoutKey:
    """The JAX model for `make_sharded_train_step`, its loss applied with
    the dropout key `DROPOUT_KEY`."""

    def __init__(self, jm):
        self.jm = jm
        self.calculate_loss = jm.calculate_loss

    def apply(self, variables, *args, method=None, **kw):
        import jax

        return self.jm.apply(variables, *args, method=method,
                             rngs={"dropout": jax.random.key(DROPOUT_KEY)}, **kw)


def _jax_draws(case, jm, params, batch, estate):
    """The draws JAX's loss takes under the dropout key, on the padded
    global batch: S3Rec's three (`tests/test_torch_s3rec.py:jax_draws`),
    SGL's two edge masks (`tests/test_torch_general_graph.py:_jax_masks`),
    the autoencoders' recorded `jax.random.bernoulli` / `normal` outputs;
    None for the other cases."""
    import jax
    import jax.numpy as jnp

    rngs = {"dropout": jax.random.key(DROPOUT_KEY)}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    je = {k: jnp.asarray(v) for k, v in estate.items()}
    if case == "S3Rec":
        key = jm.apply({"params": params}, method=lambda m: m.make_rng("dropout"), rngs=rngs)
        r_mask, r_neg, r_seg = jax.random.split(key, 3)
        seq, lengths = jb["item_id_list"], jb["item_length"]
        seg_len = max(seq.shape[1] // 4, 1)
        out = {"mask": jax.random.bernoulli(r_mask, jm.mask_ratio, seq.shape),
               "neg": jax.random.randint(r_neg, seq.shape, 1, jm.n_items),
               "start": jax.random.randint(r_seg, (seq.shape[0],), 0,
                                           jnp.maximum(lengths - seg_len, 1))}
        return {k: np.asarray(v) for k, v in out.items()}
    if case == "SGL":
        k1 = jm.apply({"params": params}, jb, je, method=lambda m, *a: m.make_rng("dropout"),
                      rngs=rngs)
        shape = estate["edge_src"].shape
        return np.stack([np.asarray(jax.random.uniform(k, shape) > jm.drop_ratio, np.float32)
                         for k in (k1, jax.random.fold_in(k1, 1))])
    if case in ("MultiVAE", "RaCT"):
        draws = []
        real = {kind: getattr(jax.random, kind) for kind in ("bernoulli", "normal")}

        def wrap(kind):
            def wrapped(*a, **k):
                got = real[kind](*a, **k)
                if not isinstance(got, jax.core.Tracer):
                    draws.append((kind, np.asarray(got)))
                return got
            return wrapped

        try:
            for kind in real:
                setattr(jax.random, kind, wrap(kind))
            jm.apply({"params": params}, jb, je, method=jm.calculate_loss, rngs=rngs)
        finally:
            for kind, f in real.items():
                setattr(jax.random, kind, f)
        return draws
    return None


def _jax_case(case, cfg):
    """JAX's sharded step of `case`: (payload for the port, loss, params
    after the step as a flat dict)."""
    import jax
    import optax

    import oovrec_tpu.cli.quick_start as jqs
    from oovrec_tpu.config import Config as JaxConfig
    from oovrec_tpu.data.utils import create_dataset, data_preparation
    from oovrec_tpu.parallel.mesh import make_mesh, pad_batch, place_batch
    from oovrec_tpu.parallel.train_step import make_sharded_train_step

    jcfg = JaxConfig(config_dict=dict(cfg, checkpoint_dir="unused"))
    ds = create_dataset(jcfg)
    train, _v, _t = data_preparation(jcfg, ds)
    template = train._make_batch(np.arange(min(2, max(len(ds.build()[0]), 1))))
    jm, variables, estate = jqs.build_model_and_state(jcfg, ds, template_batch=template)
    batch = _odd(next(iter(train)))
    params = jax.tree_util.tree_map_with_path(
        lambda p, v: np.array(v) * np.float32(
            0.01 if p[-2:-1] and p[-2].key == "float_embedding_table" else 1),
        variables["params"])
    n_data, n_model = MESHES.get(case, (2, 1))
    mesh = make_mesh(n_data, n_model, devices=jax.devices()[: n_data * n_model])
    tx = optax.adam(LR)
    est = {k: np.asarray(v) for k, v in estate.items()}
    step, _sh = make_sharded_train_step(_WithDropoutKey(jm), tx, mesh, params, batch, est,
                                        row_shard_threshold=int(cfg.get("row_shard_threshold",
                                                                        4096)))
    placed = place_batch(mesh, batch)
    start = jax.tree_util.tree_map(np.array, params)
    loss, new, _ = step(jax.tree_util.tree_map(np.array, params), tx.init(start), placed, est)
    padded = pad_batch(batch, n_data)
    draws = _jax_draws(case, jm, start, padded, est)
    # the gradient of the same loss on the padded batch, in one place
    grads = jax.jit(jax.grad(lambda q, b, e: _WithDropoutKey(jm).apply(
        {"params": q}, b, e, method=jm.calculate_loss)))(start, padded, est)
    payload = {"cfg": cfg, "params": start, "batch": batch, "draws": draws}
    return payload, float(loss), _flat(new), _flat(grads)


def _flat(tree):
    import jax

    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


# the cases of this file; `tests/test_torch_mesh_jax_graph.py` holds the
# graph and knowledge models (the JAX side takes about a minute a file)
HERE = ["FM", "GRU4Rec", "BERT4Rec", "S3Rec", "MultiVAE", "Pop"]


def run_both(tmp_path_factory, names):
    """JAX's sharded steps of the `names` cases, and the port's mesh steps
    on 2 gloo ranks: (JAX's (loss, params, gradients) by case, each rank's
    results)."""
    pytest.importorskip("jax")
    from oovrec_tpu.inductive import factory as jax_factory

    jax_factory._global_cache = jax_factory.InductiveFeatureCache("unset")
    payload, want = {}, {}
    try:
        for case in names:
            payload[case], *want[case] = _jax_case(case, CASES[case])
    finally:
        jax_factory._global_cache = jax_factory.InductiveFeatureCache("unset")
    ranks = run_ranks(__file__, 2, tmp_path_factory.mktemp("meshjax"), payload=payload)
    return want, ranks


def check_case(both, case):
    """The loss to 1e-5 relative; each gradient to 1e-5 of its leaf's
    largest entry plus 1e-7; each parameter after the Adam step to 1e-5
    where JAX's gradient exceeds 1e-6 in size. Where it does not (a
    gradient that is 0 but for the rounding, as an attention key bias's),
    Adam's first step, lr · g / (|g| + 1e-8), turns the rounding into a
    move of up to the learning rate in either direction: there both
    sides move by at most the learning rate."""
    want, ranks = both
    loss, params, jgrads = want[case]
    for rank, res in enumerate(ranks):
        got = res[case]
        assert got["loss"] == pytest.approx(loss, rel=1e-5), (rank, got["loss"], loss)
        flat = _flat(got["params"])
        assert flat.keys() == params.keys(), (rank, sorted(flat), sorted(params))
        if got["grads"] is not None:
            pg = _flat(got["grads"])
            for k, g in jgrads.items():
                np.testing.assert_allclose(pg[k], g, rtol=0,
                                           atol=1e-5 * np.abs(g).max() + 1e-7,
                                           err_msg=f"rank {rank} gradient {k}")
        for k, v in params.items():
            sure = np.abs(jgrads[k]) > 1e-6
            np.testing.assert_allclose(flat[k][sure], v[sure], rtol=1e-5, atol=1e-5,
                                       err_msg=f"rank {rank} {k}")
            assert np.all(np.abs(flat[k][~sure] - v[~sure]) <= 2 * LR * (1 + 1e-5)), k


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    return run_both(tmp_path_factory, HERE)


@pytest.mark.parametrize("case", HERE)
def test_mesh_step_matches_jax_sharded_step(both, case):
    check_case(both, case)


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
