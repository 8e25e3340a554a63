"""The port's device epoch in its pointwise and plain modes and with DHE
ids, against the JAX package.

The batch a device step assembles from given rows and given negatives
equals the JAX host batcher's `_make_batch` (its `_sample_negs` patched to
return the same negatives), key for key, integers and labels bit for bit,
at `times` 2 and 3 (pointwise) and in plain mode, on toy-ind's user and
item features: the layout the JAX device epoch follows. The JAX plain
epoch joins no features, so a context model over feature tables fails
there (a fault recorded in ROADMAP.md §3); the port's plain epoch joins
them as the host batcher does. The `<field>_dhe_id` columns equal
`DHEHasher.annotate_batch` on the same OOV-flagged batch, and their codes
the JAX SipHash of its (lo, hi) halves. Then the epochs on their own
(every real row once, labels, zero-weight padding, features equal to the
table rows of the ids), BatchNorm statistics after a device epoch equal to
those after host-path steps over the same batches (1e-6), the gates
(`device_epoch_eligible` and `_maybe_device_epoch`) equal to JAX's over a
grid, and `Trainer.fit` on the device epoch for xDeepFM, WideDeep and
DCNv2 in both modes and BPR with dhe and fdhe hashed on the device.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from oovrec_tpu.inductive.dhe import DHEHasher as JaxDHEHasher  # noqa: E402
from oovrec_tpu.ops.siphash_device import dhe_codes_device as jax_dhe_codes  # noqa: E402
from oovrec_tpu.ops.siphash_device import split_keys  # noqa: E402
from oovrec_tpu.train import device_epoch as jde  # noqa: E402
from oovrec_tpu.train import trainer as jtrainer  # noqa: E402
from oovrec_tpu.train.trainer import Trainer as JaxTrainer  # noqa: E402
from oovrec_tpu_torch.config import Config  # noqa: E402
from oovrec_tpu_torch.inductive import InductiveSpec, OOVSimulator  # noqa: E402
from oovrec_tpu_torch.ops.siphash_device import dhe_codes_device  # noqa: E402
from oovrec_tpu_torch.train import Trainer  # noqa: E402
from oovrec_tpu_torch.train import device_epoch as pde  # noqa: E402
from oovrec_tpu_torch.train import trainer as ptrainer  # noqa: E402
from oovrec_tpu_torch.utils.jax_params import batch_stats_from_module  # noqa: E402
from oovrec_tpu_torch.utils.seeding import host_rng  # noqa: E402

from tests.test_torch_train_parts import _loaders  # noqa: E402
from tests.test_torch_trainer import (  # noqa: E402
    EMB,
    _bpr_cfg,
    _dcnv2_cfg,
    _flat,
    _setup,
    _widedeep_cfg,
    _xdfm_cfg,
)

DHE = dict(EMB, dhe=dict(inductive_mapper=None, inductive_embedder="dhe", dhe_num_hashes=8,
                         dhe_layer_size=16))
MODES = {"pointwise": {"distribution": "uniform", "sample_num": 1},
         "plain": {"distribution": "none"}}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _fresh_feature_caches():
    """Both packages keep a module-global feature cache per mode."""
    from oovrec_tpu.inductive import factory as jax_factory
    from oovrec_tpu_torch.inductive import factory

    for mod in (factory, jax_factory):
        mod._global_cache = mod.InductiveFeatureCache("unset")
    yield
    for mod in (factory, jax_factory):
        mod._global_cache = mod.InductiveFeatureCache("unset")


def _ranking(tmp_path, mode, times=2, make=_xdfm_cfg, **over):
    nsa = dict(MODES[mode])
    if mode == "pointwise":
        nsa["sample_num"] = times - 1
    s = _setup(make(tmp_path, train_neg_sample_args=nsa, device_epoch=True, **over))
    cfg, model, train, valid, _ = s["port"]
    return s, Trainer(cfg, model), train


def _same_values(got, want):
    """The device batch against a host batch: the same keys, integers bit
    for bit as int64, floats as their f32 values."""
    assert set(got) == set(want), (sorted(got), sorted(want))
    for k, w in want.items():
        w, g = np.asarray(w), got[k].numpy()
        if w.dtype.kind in "iu":
            assert g.dtype == np.int64, k
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            assert g.dtype == np.float32, k
            np.testing.assert_array_equal(g, w.astype(np.float32), err_msg=k)


def _rows(de, idx):
    return {k: v[torch.from_numpy(idx)] for k, v in de.columns.items()}


# ---------------------------------------------------- the batch layouts


@pytest.mark.parametrize("times", [2, 3])
def test_pointwise_batch_matches_host_batcher(times, tmp_path):
    """Rows tiled × T, [positives ∥ negatives] in the host's order-'F'
    layout, labels [1 ∥ 0], `weight` tiled, features joined by row."""
    s, trainer, train = _ranking(tmp_path, "pointwise", times, train_batch_size=4 * times)
    jtrain = s["jax"][4]
    de = pde.DeviceEpoch(trainer, train)
    assert de.mode == jtrain.mode == "pointwise" and de.times == jtrain.times == times
    assert {"age", "gender"} <= set(de.user_feat) and {"price", "category"} <= set(de.item_feat)
    rng = np.random.default_rng(times)
    for _ in range(3):
        idx = rng.choice(len(train.split), train.step, replace=False)
        neg = rng.integers(1, train.split.item_num, (train.step, times - 1))
        jtrain._sample_negs = lambda users, neg=neg: neg
        want = jtrain._make_batch(idx)
        got = de.make_batch(_rows(de, idx), torch.ones(train.step),
                            torch.from_numpy(neg.flatten(order="F")))
        _same_values(got, want)
        assert got["label"].sum() == train.step


def test_plain_batch_matches_host_batcher(tmp_path):
    s, trainer, train = _ranking(tmp_path, "plain", train_batch_size=6)
    jtrain = s["jax"][4]
    de = pde.DeviceEpoch(trainer, train)
    assert de.mode == jtrain.mode == "plain" and de.bitmap is None and de.pop_tab is None
    rng = np.random.default_rng(1)
    for _ in range(3):
        idx = rng.choice(len(train.split), train.step, replace=False)
        _same_values(de.make_batch(_rows(de, idx), torch.ones(train.step), None),
                     jtrain._make_batch(idx))


@pytest.mark.parametrize("model", ["xDeepFM", "WideDeep"])
def test_jax_plain_epoch_joins_no_features(model, tmp_path):
    """The JAX plain device epoch feeds the split's columns alone
    (`device_epoch.py:518-521`; its feature tables are built in pointwise
    mode only, `:151-170`): a context model over toy-ind's token features
    raises. The port's plain epoch joins them and trains."""
    s, trainer, train = _ranking(tmp_path, "plain", make=_xdfm_cfg, model=model, epochs=1,
                                 train_oov=False)
    jcfg, jm, variables, estate, jtrain, _, _ = s["jax"]
    jt = JaxTrainer(jcfg, jm, variables, dict(estate))
    assert jde.device_epoch_eligible(jt, jtrain, jcfg)
    with pytest.raises(KeyError, match="absent from the batch"):
        jt._train_epoch(jtrain, 0)
    loss = trainer._train_epoch(train, 0)
    (de,) = trainer._device_epochs.values()
    assert de.mode == "plain" and np.isfinite(loss)
    _, batch = next(de.batches(0))
    assert {"gender", "category", "age", "price"} <= set(batch)


def _dhe_setup(tmp_path, embedder):
    s = _setup(_bpr_cfg(tmp_path, epochs=1, dhe_on_device=True, device_epoch=True,
                        oov_freeze_embedding=True, **DHE[embedder]))
    cfg, model, train, _, _ = s["port"]
    trainer = Trainer(cfg, model)
    trainer.oov_simulator = OOVSimulator(model.spec, model.n_users, model.n_items, 0.2,
                                         host_rng(1, "oov_regime"))
    return trainer, train


@pytest.mark.parametrize("embedder", ["dhe", "fdhe"])
def test_dhe_ids_match_annotate_batch(embedder, tmp_path):
    """On the normal and the OOV pairwise epoch, each batch's
    `<field>_dhe_id` equals `DHEHasher.annotate_batch` (the port's, hashing
    on the card) on the same batch: the user and item ids padded by
    prime_pad where flagged, the negatives raw; their codes equal the JAX
    SipHash of the JAX hasher's (lo, hi) halves."""
    trainer, train = _dhe_setup(tmp_path, embedder)
    hasher, spec = trainer.dhe_hasher, trainer.model.spec
    assert hasher.on_device
    keys = hasher.keys
    jh = JaxDHEHasher(hasher.num_hashes, str(tmp_path / "k"), keys_u64=keys, on_device=True)
    fields = ("user_id", "item_id", "neg_item_id")
    flagged = 0
    for oov in (False, True):
        de = trainer._maybe_device_epoch(train, oov=oov, frozen=oov)
        assert de is not None and de.dhe_pad == spec.prime_pad
        for _, batch in de.batches(0):
            host = {k: v.numpy().copy() for k, v in batch.items() if not k.endswith("_dhe_id")}
            jhost = dict(host)
            for f in fields:
                hasher.annotate_batch(host, f, spec.prime_pad, padded_when_flagged=True)
                jh.annotate_batch(jhost, f, spec.prime_pad, padded_when_flagged=True)
                np.testing.assert_array_equal(batch[f + "_dhe_id"].numpy(), host[f + "_dhe_id"])
                got = dhe_codes_device(batch[f + "_dhe_id"], torch.from_numpy(keys.view(np.int64)))
                want = jax_dhe_codes(jnp.asarray(jhost[f + "_dhe_lo"]),
                                     jnp.asarray(jhost[f + "_dhe_hi"]), split_keys(keys))
                np.testing.assert_array_equal(got.numpy(), np.asarray(want))
            if oov:
                flagged += int((batch["user_id_oov"] > 0).sum() + (batch["item_id_oov"] > 0).sum())
                assert "neg_item_id_oov" not in batch
    assert flagged > 0


# --------------------------------------------------- the epochs on their own


def _recorded(de, epoch=0):
    return [{k: v.clone() for k, v in b.items()} for _, b in de.batches(epoch)]


@pytest.mark.parametrize("mode,times", [("pointwise", 2), ("pointwise", 3), ("plain", 1)])
def test_epoch_invariants(mode, times, tmp_path):
    """Every real row once a positive; T - 1 valid negatives each, label 0;
    padded rows weigh 0 in every copy; every feature column equals its
    table's rows at the batch's ids."""
    _, trainer, train = _ranking(tmp_path, mode, times, train_batch_size=5 * times)
    de = pde.DeviceEpoch(trainer, train)
    seen = _recorded(de)
    assert len(seen) == de.n_steps == len(train)
    B, T = de.B, (times if mode == "pointwise" else 1)
    pos = [(int(u), int(i)) for b in seen for u, i, w in zip(
        b["user_id"][:B], b["item_id"][:B], b["weight"][:B]) if w > 0]
    split = train.split
    assert sorted(pos) == sorted(zip(split.inter["user_id"].tolist(),
                                     split.inter["item_id"].tolist()))
    used = train.sampler.used_ids["train"]
    for b in seen:
        w = b["weight"].numpy()
        assert len(w) == B * T
        real = w[:B] > 0
        for t in range(T):
            np.testing.assert_array_equal(w[t * B:(t + 1) * B], real.astype(np.float32))
        if mode == "pointwise":
            lab = b["label"].numpy()
            np.testing.assert_array_equal(lab[:B], real.astype(np.float32))
            assert (lab[B:] == 0).all()
            negs, users = b["item_id"][B:].numpy(), b["user_id"][B:].numpy()
            assert ((negs >= 1) & (negs < split.item_num)).all()
            assert not any(n in used[u] for u, n in zip(users, negs))
        for table, ids in ((de.item_feat, b["item_id"]), (de.user_feat, b["user_id"])):
            for f, t in table.items():
                assert torch.equal(b[f], t[ids]), f


@pytest.mark.parametrize("mode", ["pointwise", "plain"])
def test_batch_norm_statistics_follow_the_host_steps(mode, tmp_path):
    """DCNv2 (BatchNorm in its MLP): one device epoch against host-path
    steps over the same batches from the same weights; the running
    statistics and the parameters to 1e-6."""
    runs = []
    for _ in range(2):
        _, trainer, train = _ranking(tmp_path, mode, make=_dcnv2_cfg, train_batch_size=16)
        runs.append((trainer, train))
    (a, train_a), (b, train_b) = runs
    de = pde.DeviceEpoch(a, train_a)
    batches = _recorded(de)
    before = _flat(batch_stats_from_module(a.model))
    losses = de.run(0)
    b.model.train()
    host = torch.stack([b._step(batch, False) for batch in batches])
    np.testing.assert_allclose(losses.numpy(), host.numpy(), rtol=1e-6)
    stats_a, stats_b = _flat(batch_stats_from_module(a.model)), _flat(batch_stats_from_module(b.model))
    assert stats_a and any(not np.array_equal(stats_a[k], before[k]) for k in stats_a)
    for k in stats_b:
        np.testing.assert_allclose(stats_a[k], stats_b[k], rtol=0, atol=1e-6, err_msg=k)
    for n, p in a.params.items():
        np.testing.assert_allclose(p.detach().numpy(), b.params[n].detach().numpy(),
                                   rtol=0, atol=1e-6, err_msg=n)


# ------------------------------------------------------------ the gates


class _Hasher:
    def __init__(self, on_device):
        self.on_device = on_device


class _Model:
    def __init__(self, supports, hash_function, buckets):
        self.supports_device_epoch = supports
        self.spec = InductiveSpec(add_oov_buckets=True, n_user_buckets=buckets,
                                  n_item_buckets=8, hash_function=hash_function)


class _Fake:
    """What both packages' gates read off a trainer."""
    mesh = None

    def __init__(self, config, model, hasher):
        self.config, self.model, self.dhe_hasher = config, model, hasher
        self._device_epochs = {}


@pytest.mark.parametrize("flag", [True, False, "auto", "auto-large"])
@pytest.mark.parametrize("mode", ["pairwise", "pointwise", "plain"])
def test_gates_match_jax(mode, flag, monkeypatch):
    """`device_epoch_eligible` and `_maybe_device_epoch` (normal, OOV and
    frozen OOV sub-epochs) give JAX's answer for every model flag, DHE
    hasher (none, on the host, on the device) and bucket hashing (a device
    hash within 2^16 buckets, or beyond): the OOV sub-epochs take the
    device only in pairwise mode."""
    if flag == "auto-large":
        monkeypatch.setattr(jde, "AUTO_MIN_ROWS", 1)
        monkeypatch.setattr(pde, "AUTO_MIN_ROWS", 1)
    value = "auto" if flag == "auto-large" else flag
    monkeypatch.setattr(jde, "DeviceEpoch", lambda *a, **k: "device")
    monkeypatch.setattr(ptrainer, "DeviceEpoch", lambda *a, **k: "device")
    jcfg, jl, pl = _loaders(mode)
    jcfg["device_epoch"] = value
    pcfg = Config(dict(pl.config.as_dict(), device_epoch=value))
    seen = set()
    for supports in (True, False):
        for hasher in (None, False, True):
            for hash_function, buckets in (("3round", 8), ("mod", 65537), ("other", 8)):
                h = None if hasher is None else _Hasher(hasher)
                jf = _Fake(jcfg, _Model(supports, hash_function, buckets), h)
                pf = _Fake(pcfg, _Model(supports, hash_function, buckets), h)
                want = jde.device_epoch_eligible(jf, jl, jcfg)
                assert pde.device_epoch_eligible(pf, pl, pcfg) == want
                for oov, frozen in ((False, False), (True, False), (True, True)):
                    want = jtrainer.Trainer._maybe_device_epoch(jf, jl, oov, frozen)
                    got = ptrainer.Trainer._maybe_device_epoch(pf, pl, oov, frozen)
                    assert got == want, (supports, hasher, hash_function, oov, frozen)
                    seen.add((oov, want))
    on = flag in (True, "auto-large")
    assert ((False, "device") in seen) == on
    assert ((True, "device") in seen) == (on and mode == "pairwise")


# ---------------------------------------------------------- Trainer.fit


FIT = {
    "xdeepfm": _xdfm_cfg,
    "widedeep": _widedeep_cfg,
    "dcnv2": _dcnv2_cfg,
}


@pytest.mark.parametrize("mode", ["pointwise", "plain"])
@pytest.mark.parametrize("model", list(FIT))
def test_fit_on_the_device_epoch(model, mode, tmp_path):
    """`device_epoch: true` trains the ranking models on the pointwise and
    plain device epochs (the OOV sub-epochs on the host path, as in JAX):
    finite losses, every step's loss, the global step, moved weights."""
    _, trainer, train = _ranking(tmp_path, mode, make=FIT[model], oov_freeze_embedding=True)
    before = {n: p.detach().clone() for n, p in trainer.params.items()}
    trainer.fit(train, None, saved=False)
    des = list(trainer._device_epochs.values())
    assert len(des) == 1 and des[0].mode == mode and not des[0].oov
    assert trainer.oov_loss_dict and all(np.isfinite(v) for v in trainer.train_loss_dict.values())
    assert len(trainer.last_losses) > 0
    moved = {n for n, p in trainer.params.items() if not torch.equal(p, before[n])}
    assert any("oov_bucket" not in n for n in moved)


@pytest.mark.parametrize("embedder", ["dhe", "fdhe"])
def test_dhe_takes_the_device_epoch_when_hashed_on_device(embedder, tmp_path):
    """BPR with dhe and fdhe under `dhe_on_device`: the normal and the
    frozen OOV sub-epoch both on the device epoch, finite losses."""
    trainer, train = _dhe_setup(tmp_path, embedder)
    trainer.fit(train, None, saved=False)
    assert {(d.oov, d.frozen) for d in trainer._device_epochs.values()} == {(False, False),
                                                                           (True, True)}
    assert np.isfinite(trainer.train_loss_dict[0]) and np.isfinite(trainer.oov_loss_dict[0])
