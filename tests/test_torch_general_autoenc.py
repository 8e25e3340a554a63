"""The user-batch loader and the seven user-batch general models against
the JAX package, on the CPU: MultiVAE, MultiDAE, CDAE, RecVAE, MacridVAE,
RaCT and ENMF.

`UserTrainBatcher` gives JAX's batches bit for bit over two epochs (the
users shuffled by `host_rng(seed + epoch, "user_batcher")`, the last
batch padded with user 0 at weight 0), and `data_preparation` picks the
loader in JAX's order: a knowledge model is refused before a
`train_on_users` one gets the user batches. On a seeded training matrix
(30 users × 20 items) each model, its flax params bridged into the port,
gives JAX's full sort and `predict`, and its loss and the gradient of
every parameter to 1e-5 on JAX's own draws (the keep masks of its
dropout, ε, RaCT's held-out mask), recorded from `jax.random` and replayed
through the port's `draws`; the port draws them from the dropout
generator. RaCT in each of its three stages (the parameters a stage
detaches get a zero gradient), its NDCG and its ddof-0 standardisation.
The OOV sub-epoch on a user batch at `oov_train_ratio: 1.0`, for seeds
whose first draw takes each of the simulator's three options: where the
option pads users both packages train on (the same losses), where it pads
items both raise the same KeyError (a user batch has no item column:
ROADMAP §3). End to end on toy, MultiDAE, CDAE and ENMF at dropout 0
train two epochs through `quick_start.run` from the JAX run's initial
weights (losses to 1e-5 relative, metrics to 1e-5); the four VAEs, whose
ε the port draws from another generator, train two epochs with finite
losses and metrics.
"""

import copy

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import oovrec_tpu.cli.quick_start as jax_quick_start  # noqa: E402
import oovrec_tpu_torch.cli.quick_start as port_quick_start  # noqa: E402
import oovrec_tpu_torch.data.utils as port_utils  # noqa: E402
from oovrec_tpu.config import Config as JaxConfig  # noqa: E402
from oovrec_tpu.data.dataset import Dataset as JaxDataset  # noqa: E402
from oovrec_tpu.data.utils import data_preparation as jax_prep  # noqa: E402
from oovrec_tpu.models import get_model_class as jax_model_class  # noqa: E402
from oovrec_tpu_torch.config import Config  # noqa: E402
from oovrec_tpu_torch.data.dataloader import TrainBatcher, UserTrainBatcher  # noqa: E402
from oovrec_tpu_torch.data.dataset import Dataset  # noqa: E402
from oovrec_tpu_torch.models import get_model_class  # noqa: E402
from oovrec_tpu_torch.models.layers import RandomDraws, set_dropout_generator  # noqa: E402
from oovrec_tpu_torch.utils.enums import ModelType  # noqa: E402
from oovrec_tpu_torch.utils.jax_params import flax_from_state_dict, load_flax_params  # noqa: E402
from oovrec_tpu_torch.utils.seeding import host_rng  # noqa: E402

from tests.test_torch_cli import ASSETS  # noqa: E402
from tests.test_torch_dataset import TOY, _same_arrays  # noqa: E402
from tests.test_torch_general_pairs import N_ITEMS, N_USERS, SPLIT, _flat, _tb  # noqa: E402
from tests.test_torch_seq_slice import _bridge  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
SMALL_VAE = {"latent_dim": 4, "encoder_hidden": (6,)}
CASES = {
    "MultiVAE": ("MultiVAE", SMALL_VAE),
    "MultiDAE": ("MultiDAE", SMALL_VAE),
    "CDAE": ("CDAE", {}),
    "RecVAE": ("RecVAE", {"latent_dim": 4, "hidden_dim": 6}),
    "MacridVAE": ("MacridVAE", {"kfac": 3, "latent_dim": 4, "encoder_hidden": (6,),
                                "tau": 0.5}),
    "ENMF": ("ENMF", {}),
    **{f"RaCT-{stage}": ("RaCT", {**SMALL_VAE, "critic_layers": (5, 4), "metrics_k": 5,
                                  "train_stage": stage})
       for stage in ("actor_pretrain", "critic_pretrain", "finetune")},
}
ESTATES = {name: jax_model_class(name).build_estate(SPLIT) for name, _ in CASES.values()}


@pytest.mark.parametrize("batch_size", [4, 64])
def test_user_batches_match_jax(batch_size):
    cfg = dict(TOY, model="MultiVAE", train_batch_size=batch_size, seed=7)
    pcfg, jcfg = Config(copy.deepcopy(cfg)), JaxConfig(config_dict=copy.deepcopy(cfg))
    port = data_preparation_train(pcfg)
    want = jax_prep(jcfg, JaxDataset(jcfg))[0]
    assert isinstance(port, UserTrainBatcher) and type(want).__name__ == "UserTrainBatcher"
    assert len(port) == len(want)
    got = [b for _ in range(2) for b in port]
    expect = [b for _ in range(2) for b in want]
    assert len(got) == len(expect) == 2 * len(want)
    for i, (p, j) in enumerate(zip(got, expect)):
        _same_arrays(p, j, f"batch {i}")
        assert list(p) == ["user_id", "weight"]
    if batch_size == 64:  # one padded batch
        assert got[0]["weight"].sum() < batch_size and not got[0]["user_id"][-1]
    assert got[0]["user_id"].tolist() != got[len(port)]["user_id"].tolist()  # reshuffled
    _same_arrays(port._make_batch(np.arange(2)), want._make_batch(np.arange(2)), "template")


def data_preparation_train(config):
    return port_utils.data_preparation(config, Dataset(config))[0]


def test_data_preparation_branch_order(monkeypatch):
    """The JAX package's order (`data/utils.py:132-163` there): a knowledge
    dataset takes `KGTrainBatcher`, whatever the model trains on; then a
    model trained on users takes `UserTrainBatcher`; then rows."""
    from oovrec_tpu_torch.data.dataloader import KGTrainBatcher
    from oovrec_tpu_torch.data.kg_dataset import KnowledgeBasedDataset

    cfg = Config(dict(TOY, model="MultiVAE", train_batch_size=8))
    kg = Config(dict(model="MultiVAE", dataset="toy-kg", data_path=ASSETS, train_batch_size=8,
                     load_col={"inter": ["user_id", "item_id", "rating", "timestamp"]}))

    class Users:
        model_type = ModelType.GENERAL
        train_on_users = True

    class Rows:
        model_type = ModelType.GENERAL

    monkeypatch.setattr(port_utils, "_model_class", lambda config: Users)
    assert isinstance(port_utils.data_preparation(kg, KnowledgeBasedDataset(kg))[0],
                      KGTrainBatcher)
    assert isinstance(data_preparation_train(cfg), UserTrainBatcher)
    monkeypatch.setattr(port_utils, "_model_class", lambda config: Rows)
    assert isinstance(data_preparation_train(cfg), TrainBatcher)


class _Recorder:
    """Records the outputs of `jax.random.bernoulli` / `normal`, in order
    (flax's shape checks of its initializers draw traced values: skipped)."""

    def __init__(self, monkeypatch):
        self.draws = []
        for kind in ("bernoulli", "normal"):
            real = getattr(jax.random, kind)

            def wrapped(*a, _real=real, _kind=kind, **k):
                out = _real(*a, **k)
                if not isinstance(out, jax.core.Tracer):
                    self.draws.append((_kind, np.asarray(out)))
                return out

            monkeypatch.setattr(jax.random, kind, wrapped)


class _Replay(RandomDraws):
    """JAX's recorded draws, handed out in order."""

    def __init__(self, draws):
        super().__init__()
        self.queue = list(draws)

    def _next(self, kind, shape):
        got, arr = self.queue.pop(0)
        assert got == kind and arr.shape == tuple(shape), (got, kind, arr.shape, shape)
        return torch.from_numpy(arr.astype(np.float32))

    def keep(self, p, shape, device):
        return self._next("bernoulli", shape)

    def normal(self, shape, device):
        return self._next("normal", shape)


def _batch(seed=1, B=7):
    rng = np.random.default_rng(seed)
    users = rng.choice(np.arange(1, N_USERS), B, replace=False)
    users[-1] = 0
    return {"user_id": users, "weight": np.r_[np.ones(B - 1), 0.0].astype(np.float32)}


def _both(case, batch, seed=0):
    name, kw = CASES[case]
    jm = jax_model_class(name)(n_users=N_USERS, n_items=N_ITEMS, embedding_size=8, **kw)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    je = {k: jnp.asarray(v) for k, v in ESTATES[name].items()}
    params = jm.init({"params": jax.random.key(seed), "dropout": jax.random.key(1)}, jb, je,
                     method=jm.calculate_loss)["params"]
    rng = np.random.default_rng(seed + 7)
    params = jax.tree_util.tree_map_with_path(
        lambda path, v: jnp.asarray(np.asarray(v) + (
            rng.standard_normal(v.shape).astype(np.float32) * 0.1
            if getattr(path[-1], "key", "").startswith(("bias", "critic_b")) else 0)),
        params)
    port = get_model_class(name)(N_USERS, N_ITEMS, embedding_size=8, device="cpu", **kw,
                                 **ESTATES[name])
    load_flax_params(port, params)
    return jm, params, jb, je, port


@pytest.mark.parametrize("case", sorted(CASES))
def test_outputs_match_jax(case):
    batch = dict(_batch(), item_id=np.arange(7) % N_ITEMS)
    jm, params, jb, je, port = _both(case, batch)
    port.eval()
    with torch.no_grad():
        for method in ("predict", "full_sort_scores"):
            want = np.asarray(jm.apply({"params": params}, jb, je, method=getattr(jm, method)))
            np.testing.assert_allclose(getattr(port, method)(_tb(batch)).numpy(), want,
                                       err_msg=method, **TOL)
    assert _flat(flax_from_state_dict(port.state_dict(), port)).keys() == _flat(params).keys()


@pytest.mark.parametrize("case", sorted(CASES))
def test_loss_and_gradients_on_jax_draws(case, monkeypatch):
    batch = _batch(seed=2)
    jm, params, jb, je, port = _both(case, batch, seed=1)
    rngs = {"dropout": jax.random.key(5)}
    rec = _Recorder(monkeypatch)
    jm.apply({"params": params}, jb, je, method=jm.calculate_loss, rngs=rngs)
    drawn = list(rec.draws)
    monkeypatch.undo()
    want, jgrads = jax.value_and_grad(lambda p: jm.apply(
        {"params": p}, jb, je, method=jm.calculate_loss, rngs=rngs))(params)
    kinds = [k for k, _ in drawn]
    assert ("normal" in kinds) == ("VAE" in case or "RaCT" in case), kinds
    port.draws = _Replay(drawn)
    port.train()
    named = list(port.named_parameters())
    loss = port.calculate_loss(_tb(batch))
    assert not port.draws.queue, "JAX drew more than the port took"
    grads = torch.autograd.grad(loss, [p for _, p in named], allow_unused=True)
    np.testing.assert_allclose(loss.item(), float(want), **TOL)
    pg = _flat(flax_from_state_dict({n: torch.zeros_like(p) if g is None else g
                                     for (n, p), g in zip(named, grads)}, port))
    jg = _flat(jgrads)
    assert pg.keys() == jg.keys()
    for k in jg:
        np.testing.assert_allclose(pg[k], jg[k], err_msg=k, **TOL)
    if case.startswith("RaCT"):  # what the stage detaches or does not read
        critic = [k for k in jg if "critic" in k]
        still = critic if not case.endswith("critic_pretrain") else \
            [k for k in jg if k not in critic]
        assert all(not pg[k].any() and not np.asarray(jg[k]).any() for k in still)
        assert all(pg[k].any() for k in jg if k not in still), case


def test_draws_come_from_the_dropout_generator():
    batch = _tb(_batch())
    port = get_model_class("MultiVAE")(N_USERS, N_ITEMS, embedding_size=8, device="cpu",
                                       **SMALL_VAE, **ESTATES["MultiVAE"])
    with pytest.raises(RuntimeError, match="explicit generator"):
        port.calculate_loss(batch)
    set_dropout_generator(port, torch.Generator().manual_seed(3))
    a = port.calculate_loss(batch)
    set_dropout_generator(port, torch.Generator().manual_seed(3))
    assert torch.equal(a, port.calculate_loss(batch)) and torch.isfinite(a)
    assert not torch.equal(a, port.calculate_loss(batch))


def test_ract_ndcg_and_standardisation():
    jm, params, jb, je, port = _both("RaCT-finetune", _batch())
    rng = np.random.default_rng(9)
    logits = rng.standard_normal((6, N_ITEMS)).astype(np.float32)
    hist = (rng.random((6, N_ITEMS)) < 0.4).astype(np.float32)
    keep = (rng.random((6, N_ITEMS)) < 0.5).astype(np.float32)
    seen, unseen = hist * keep, hist * (1 - keep)
    unseen[0] = 0  # a user with nothing held out: NDCG 0
    want = jm.apply({"params": params}, jnp.asarray(logits), jnp.asarray(unseen),
                    jnp.asarray(seen), method=jm._ndcg)
    got = port.ndcg(*(torch.from_numpy(x) for x in (logits, unseen, seen)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert float(got[0]) == 0.0
    feats = (rng.standard_normal((6, 3)) * [1, 5, 20]).astype(np.float32)
    want = jm.apply({"params": params}, jnp.asarray(feats), False, method=jm._critic)
    with torch.no_grad():
        got = port.critic(torch.from_numpy(feats), False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    f = torch.from_numpy(feats)
    assert not torch.allclose(f.std(dim=0), f.std(dim=0, correction=0))


def _cfg(model, **over):
    d = dict(model=model, dataset="toy", data_path=ASSETS, epochs=2, train_batch_size=8,
             eval_batch_size=64, embedding_size=8, log_tensorboard=False, seed=11,
             load_col={"inter": ["user_id", "item_id", "rating", "timestamp"]},
             eval_args={"split": {"RS": [8, 1, 1]}, "order": "RO", "group_by": "user",
                        "mode": "full"})
    d.update(over)
    return d


def _oov_option(seed):
    """The simulator's option for the first batch of the sub-epoch: the
    second draw of `host_rng(seed, "oov_regime")` (the keep draw first)."""
    rng = host_rng(seed, "oov_regime")
    rng.random()
    return int(rng.integers(0, 3))


OOV_SEEDS = {}
for _seed in range(40):
    OOV_SEEDS.setdefault(_oov_option(_seed), _seed)


@pytest.mark.parametrize("option", [0, 1, 2])
def test_oov_sub_epoch_on_user_batches(option, tmp_path, monkeypatch):
    _bridge(monkeypatch)
    seed = OOV_SEEDS[option]
    cfg = dict(model="MultiDAE", dataset="toy-ind", data_path=ASSETS, epochs=1,
               train_batch_size=64, embedding_size=8, log_tensorboard=False, seed=seed,
               dropout_prob=0.0, latent_dim=4, encoder_hidden=[6], inductive_mapper="random",
               add_oov_buckets=True, n_user_oov_buckets=8, n_item_oov_buckets=8,
               train_oov=True, oov_train_ratio=1.0,
               load_col={"inter": ["user_id", "item_id", "rating", "timestamp", "is_new"]})
    runs = {}
    for pkg, run, extra in (("jax", jax_quick_start.run, {}),
                            ("port", port_quick_start.run, {"device": "cpu"})):
        try:
            res = run(config_dict=dict(cfg, checkpoint_dir=str(tmp_path / pkg), **extra),
                      saved=False)
            runs[pkg] = res["trainer"]
        except KeyError as e:
            runs[pkg] = e
    if option == 1:  # users padded: both train the sub-epoch
        j, p = runs["jax"], runs["port"]
        assert list(p.oov_loss_dict) == list(j.oov_loss_dict) == [0]
        np.testing.assert_allclose(p.train_loss_dict[0], j.train_loss_dict[0], rtol=1e-5)
        np.testing.assert_allclose(p.oov_loss_dict[0], j.oov_loss_dict[0], rtol=1e-5)
    else:  # items padded: the batch has no item column in either package
        assert isinstance(runs["jax"], KeyError) and isinstance(runs["port"], KeyError), runs
        assert "item_id" in str(runs["jax"]) and "item_id" in str(runs["port"])


FITS = {
    "MultiDAE": {"dropout_prob": 0.0, "latent_dim": 4, "encoder_hidden": [6]},
    "CDAE": {"corruption_ratio": 0.0},
    "ENMF": {"dropout_prob": 0.0},
}


@pytest.mark.parametrize("name", sorted(FITS))
def test_run_matches_jax(name, tmp_path, monkeypatch):
    from tests.test_torch_general_pairs import _agree

    _bridge(monkeypatch)
    cfg = _cfg(name, **FITS[name])
    jres = jax_quick_start.run(config_dict=dict(cfg, checkpoint_dir=str(tmp_path / "jax")),
                               saved=False)
    pres = port_quick_start.run(config_dict=dict(cfg, device="cpu",
                                                 checkpoint_dir=str(tmp_path / "port")),
                                saved=False)
    jt, pt = jres["trainer"], pres["trainer"]
    assert type(pt.model).__name__ == name
    assert list(pt.train_loss_dict) == list(jt.train_loss_dict) == [0, 1]
    for e, want in jt.train_loss_dict.items():
        np.testing.assert_allclose(pt.train_loss_dict[e], want, rtol=1e-5, err_msg=f"epoch {e}")
    _agree(jres["best_valid_result"], pres["best_valid_result"], 1e-5, "valid")
    _agree(jres["test_result"], pres["test_result"], 1e-5, "test")


@pytest.mark.parametrize("name", ["MultiVAE", "RecVAE", "MacridVAE", "RaCT"])
def test_vae_runs_are_finite(name, tmp_path):
    res = port_quick_start.run(config_dict=_cfg(name, device="cpu",
                                                checkpoint_dir=str(tmp_path)), saved=False)
    losses = res["trainer"].train_loss_dict
    assert list(losses) == [0, 1] and all(np.isfinite(v) for v in losses.values())
    for result in (res["best_valid_result"], res["test_result"]):
        assert all(0.0 <= float(v) <= 1.0 for v in result.values()), result
