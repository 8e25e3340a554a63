"""The port's device-resident pairwise epoch against the JAX package.

Deterministic pieces bit for bit: the int64 bucket hashes against JAX's
uint32-pair emulation and the host `hash_ids`, the used-pair bitmap, the
alias table and its draw, the bounded resampling rule given the same
candidate draws. The sparse train step against JAX's per-step math
composed from its public functions (`device_epoch.py:456-514`, as
`bench.py` composes it), from bridged weights and a bridged non-zero
lazy-Adam state, to 1e-5. Then the port's epoch on its own on toy data
with a CPU `torch.Generator` (the streams cannot match `jax.random`):
every row once, valid negatives, OOV buckets, the frozen sub-epoch, the
sparse epoch against the dense lazy sweep, repeatability, and the
eligibility gates against `device_epoch_eligible`. Then the embedders:
lsh, slsh, dnn, knn, zero and mean take the device epoch (the sparse path
with lsh, slsh and dnn equal to the dense sweep, which checks that the
feature lookups read entity ids and not row positions; kernel 6's route
and the plain route bit for bit), while DHE and fDHE hashed on the host
(`dhe_on_device: false`) keep to the host path under `device_epoch: true`
and `auto`, as the JAX gate keeps them (`test_torch_device_epoch_modes.py`
holds them on the device epoch under `dhe_on_device`).
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402

from oovrec_tpu.data import alias as jax_alias  # noqa: E402
from oovrec_tpu.ops.inthash_device import sim_buckets_device as jax_sim_buckets  # noqa: E402
from oovrec_tpu.train import device_epoch as jde  # noqa: E402
from oovrec_tpu.train import sparse_update as jsu  # noqa: E402
from oovrec_tpu.train.optimizers import ScaleByLazyAdamState, build_optimizer  # noqa: E402
from oovrec_tpu.utils.seeding import host_rng as jax_host_rng  # noqa: E402
from oovrec_tpu.inductive.transform import OOVSimulator as JaxOOVSimulator  # noqa: E402
from oovrec_tpu_torch.config import Config  # noqa: E402
from oovrec_tpu_torch.data import DatasetSplit, Sampler, TrainBatcher  # noqa: E402
from oovrec_tpu_torch.data import alias  # noqa: E402
from oovrec_tpu_torch.inductive import InductiveSpec, OOVSimulator  # noqa: E402
from oovrec_tpu_torch.inductive.factory import exact_knn_neighbors  # noqa: E402
from oovrec_tpu_torch.inductive.hashes import hash_ids  # noqa: E402
from oovrec_tpu_torch.models import BPR  # noqa: E402
from oovrec_tpu_torch.ops.inthash_device import sim_buckets_device  # noqa: E402
from oovrec_tpu_torch.train import Trainer  # noqa: E402
from oovrec_tpu_torch.train import device_epoch as pde  # noqa: E402
from oovrec_tpu_torch.utils.enums import InputType  # noqa: E402
from oovrec_tpu_torch.utils.jax_params import (  # noqa: E402
    flax_from_state_dict,
    opt_state_from_flax,
)
from oovrec_tpu_torch.utils.seeding import host_rng, torch_generator  # noqa: E402

from tests.test_torch_train_parts import _loaders  # noqa: E402
from tests.test_torch_trainer import _bpr_cfg, _flat, _setup  # noqa: E402
from tests.test_torch_xdeepfm import _jax_batch  # noqa: E402

PRIME = 112062759511


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The port's CPU ops at these tiny shapes run fastest on one thread:
    several test workers each spreading a 512-element GELU over every core
    spend milliseconds a call on the thread pool alone."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# --------------------------------------------------------- bit-exact pieces


@pytest.mark.parametrize("fn", ["mod", "3round", "fast", "64bit"])
def test_sim_buckets_device_matches_jax_and_host(fn):
    """4096 ids up to 2^31 - 1 (the extremes included), at (n_orig,
    buckets) of (1801, 200), (100, 16) and (7, 65536)."""
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 2**31 - 1, 4096)
    ids[:3] = [0, 2**31 - 2, 2**31 - 1]
    for n_orig, nb in ((1801, 200), (100, 16), (7, 65536)):
        host = hash_ids(ids + PRIME - n_orig, nb, fn)
        got = sim_buckets_device(torch.from_numpy(ids), n_orig, nb, fn, PRIME)
        want = np.asarray(jax.jit(lambda i, n_orig=n_orig, nb=nb: jax_sim_buckets(
            i, n_orig, nb, fn, PRIME))(jnp.asarray(ids.astype(np.int32))))
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"{fn} {nb}")
        np.testing.assert_array_equal(got.numpy(), host, err_msg=f"{fn} {nb}")


def _per_user(rng, n_users, n_items):
    per = [np.unique(rng.integers(1, n_items, int(rng.integers(0, n_items))))
           for _ in range(n_users)]
    per[1] = np.array([], np.int64)
    per[2] = np.arange(1, n_items)  # every item used
    return per


@pytest.mark.parametrize("n_items", [40, 64, 97])
def test_used_bitmap_matches_jax(n_items):
    """Bit for bit against the JAX `build_used_bitmap`: users with no items,
    with every item, items in every word; PAD set everywhere."""
    rng = np.random.default_rng(n_items)
    n_users = 9
    per = _per_user(rng, n_users, n_items)
    want = jde.build_used_bitmap(per, n_users, n_items)
    got = pde.build_used_bitmap(per, n_users, n_items)
    assert got.dtype == torch.int32 and got.shape == want.shape == (n_users, -(-n_items // 32))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[:, 0] & 1).all()


def test_alias_table_and_draw_match_jax():
    rng = np.random.default_rng(3)
    p = rng.random(300) ** 3
    p[[0, 17, 200]] = 0.0
    prob, al = alias.build_alias_table(p)
    jprob, jal = jax_alias.build_alias_table(p)
    np.testing.assert_array_equal(prob, jprob)
    np.testing.assert_array_equal(al, jal)
    np.testing.assert_allclose(alias.reconstruct_p(prob, al), p / p.sum(), atol=1e-6)
    np.testing.assert_array_equal(alias.reconstruct_p(prob, al), jax_alias.reconstruct_p(jprob, jal))
    # the draw: the JAX formula on the same uniforms
    shape = (4, 5000)
    got = alias.alias_draw(torch_generator(9), shape, torch.from_numpy(prob), torch.from_numpy(al))
    u = torch.rand(shape, generator=torch_generator(9)).numpy() * len(p)
    k = np.minimum(jnp.asarray(u).astype(jnp.int32), len(p) - 1)
    frac = jnp.asarray(u) - k.astype(jnp.float32)
    want = jnp.where(frac < jnp.asarray(prob)[k], k, jnp.asarray(al)[k])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.int64
    assert not np.isin(got.numpy(), [0, 17, 200]).any()
    freq = np.bincount(got.numpy().ravel(), minlength=len(p)) / got.numel()
    assert np.abs(freq - p / p.sum()).max() < 0.01


def _jax_resampling_rule(bitmap, users, draws, R, CH=4):
    """JAX's `sample_negs` (device_epoch.py:271-314) with its `draw` replaced
    by the given rounds (draws[R] is the give-up draw): CH rounds an
    iteration until every lane has resolved."""
    bitmap, users, draws = jnp.asarray(bitmap), jnp.asarray(users), jnp.asarray(draws)
    n = users.shape[0]
    lanes = jnp.arange(n)
    c, ok = draws[R], jnp.zeros(n, bool)
    for i in range(R // CH):
        if bool(jnp.all(ok)):
            break
        d = draws[i * CH:(i + 1) * CH]
        free = ~(((bitmap[users[None, :], d >> 5] >> (d & 31)) & 1) == 1)
        any_free = jnp.any(free, axis=0)
        cand = d[jnp.argmax(free, axis=0), lanes]
        c = jnp.where(~ok & any_free, cand, c)
        ok = ok | any_free
    return np.asarray(c)


def _toy(n_users=30, n_items=50, n_rows=400, seed=0, heavy=True):
    """Toy pairwise rows: user 1 uses all but 10 items when `heavy`."""
    rng = np.random.default_rng(seed)
    users = rng.integers(1, n_users, n_rows)
    items = rng.integers(1, n_items, n_rows)
    if heavy:
        users = np.concatenate([users, np.ones(n_items - 11, np.int64)])
        items = np.concatenate([items, np.arange(1, n_items - 10)])
    return DatasetSplit({"user_id": users, "item_id": items}, n_users, n_items)


SPEC = dict(mapper="random", add_oov_buckets=True, n_user_buckets=8, n_item_buckets=8,
            hash_function="3round")


def _trainer(split, impl="auto", learner="sparse_adam", seed=11, **over):
    cfg = Config(dict(dict(
        seed=seed, train_batch_size=64, learner=learner, learning_rate=1e-2, epochs=2,
        train_oov=True, oov_only_epoch=True, oov_train_ratio=0.8, oov_feature_mask_rate=0.2,
        device_epoch=True, sparse_update_impl=impl), **over))
    model = BPR(split.user_num, split.item_num, 8, InductiveSpec(**SPEC), device="cpu",
                generator=torch_generator(5))
    sampler = Sampler(["train"], [split], seed=seed)
    return Trainer(cfg, model), TrainBatcher(split, sampler, cfg, InputType.PAIRWISE)


def test_resampling_rule_matches_jax_given_the_same_draws():
    """The first unused of R candidate draws, else the give-up draw: the
    port's all-rounds-at-once form equals JAX's chunked while-loop."""
    split = _toy()
    trainer, loader = _trainer(split)
    de = pde.DeviceEpoch(trainer, loader)
    rng = np.random.default_rng(4)
    R = de.rounds
    users = np.resize(np.arange(split.user_num), 256)
    draws = rng.integers(1, split.item_num, (R + 1, 256))
    draws[:, :3] = rng.integers(1, 4, (R + 1, 3))  # few distinct: give-ups
    de.draw = lambda gen, shape: torch.from_numpy(draws).reshape(shape)
    got = de.sample_negs(None, torch.from_numpy(users))
    want = _jax_resampling_rule(de.bitmap.numpy(), users, draws, R)
    np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------------------ the step vs JAX


def _jax_sparse_step(jm, estate, tx, lr, params, opt_state, batch):
    """JAX's sparse train step from its public functions
    (`device_epoch.py:456-514`)."""
    stm = jm.sparse_table_fields()
    names = {n for n, _f in stm.values()}
    rows, nb, gathered = jsu.gather_rows_for_batch(params, batch, stm)
    rest = jsu.prune_tables(params, names)
    tables = {k: params[k]["embedding"] for k in names}

    def loss_fn(rows, rest):
        b2 = dict(nb, **{"_sparse_rows_" + s: r for s, r in rows.items()})
        return jm.apply({"params": jsu.merge_tables(rest, tables)}, b2, estate,
                        method=jm.calculate_loss)

    loss, (g_rows, g_rest) = jax.value_and_grad(loss_fn, argnums=(0, 1))(rows, rest)
    rest_state, sparse_states = jsu.split_lazy_opt_state(opt_state, names, stm)
    updates, new_rest_state = tx.update(g_rest, rest_state, rest)
    new_rest = optax.apply_updates(rest, updates)
    count = new_rest_state[0].count
    new_tabs, new_sparse = {}, {}
    for side, (name, _f) in stm.items():
        new_tabs[name], new_sparse[side] = jsu.sparse_adam_update_table(
            tables[name], sparse_states[side], gathered[side], g_rows[side], count, lr,
            impl="xla")
    return (float(loss), jsu.merge_tables(new_rest, new_tabs),
            jsu.merge_lazy_opt_state(new_rest_state, new_sparse, stm))


def test_sparse_step_matches_jax_step_by_step(tmp_path):
    """Eight batches of the port's `TrainBatcher` (every other one through
    the OOV simulator of each package) fed to the port's `DeviceEpoch`
    step and to JAX's composed step, from the JAX init and a non-zero
    lazy-Adam state crossed through the bridge: losses to 1e-5 relative,
    parameters and moments to 1e-5, the count exactly."""
    s = _setup(_bpr_cfg(tmp_path, learner="sparse_adam", learning_rate=1e-2))
    jcfg, jm, variables, estate, jtrain, _, _ = s["jax"]
    cfg, model, train, _, _ = s["port"]
    lr = float(jcfg["learning_rate"])
    tx = build_optimizer("sparse_adam", lr)
    params = variables["params"]
    rng = np.random.default_rng(8)
    state0 = tx.init(params)
    opt_state = (ScaleByLazyAdamState(
        jnp.int32(5),
        jax.tree_util.tree_map(lambda v: jnp.asarray(rng.standard_normal(v.shape) * 0.01,
                                                     jnp.float32), state0[0].mu),
        jax.tree_util.tree_map(lambda v: jnp.asarray(rng.random(v.shape) * 1e-3,
                                                     jnp.float32), state0[0].nu)),
    ) + tuple(state0[1:])
    trainer = Trainer(cfg, model)
    trainer.opt_state = opt_state_from_flax(opt_state, "lazy_adam", model)
    de = pde.DeviceEpoch(trainer, train)
    assert de.sparse_tables == {s: (n, f) for s, (n, f) in model.sparse_table_fields().items()}
    seed = int(jcfg["seed"])
    spec_kw = dict(mapper="random", add_oov_buckets=True, n_user_buckets=8, n_item_buckets=8)
    from oovrec_tpu.inductive.spec import InductiveSpec as JaxSpec

    psim = OOVSimulator(InductiveSpec(**spec_kw), train.split.user_num, train.split.item_num,
                        0.2, host_rng(seed, "x"))
    jsim = JaxOOVSimulator(JaxSpec(**spec_kw), train.split.user_num, train.split.item_num,
                           0.2, jax_host_rng(seed, "x"))
    n = 0
    for _ in range(4):
        for batch in train:
            if n % 2:
                pb, jb = psim(batch), jsim(dict(batch))
            else:
                pb = jb = batch
            loss = de.train_step({k: torch.from_numpy(np.asarray(v)) for k, v in pb.items()})
            jloss, params, opt_state = _jax_sparse_step(jm, estate, tx, lr, params, opt_state,
                                                        _jax_batch(jb))
            np.testing.assert_allclose(float(loss), jloss, rtol=1e-5, err_msg=f"step {n}")
            n += 1
            if n == 8:
                break
        if n == 8:
            break
    assert n == 8
    got = _flat(flax_from_state_dict(model.state_dict(), model))
    want = _flat(params)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5, err_msg=k)
    assert trainer.opt_state["count"] == int(opt_state[0].count) == 13
    for part in ("mu", "nu"):
        got = _flat(flax_from_state_dict(trainer.opt_state[part], model))
        want = _flat(getattr(opt_state[0], part))
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5, err_msg=f"{part} {k}")


# ----------------------------------------------------- the epoch on its own


def _recorded(de, epoch=0):
    """The epoch's batches, as numpy, in order, while it trains."""
    seen = []
    step = de.train_step

    def rec(batch):
        seen.append({k: v.numpy().copy() for k, v in batch.items()})
        return step(batch)

    de.train_step = rec
    losses = de.run(epoch)
    return seen, losses


def test_epoch_uses_every_row_once_with_valid_negatives():
    split = _toy()
    trainer, loader = _trainer(split)
    de = pde.DeviceEpoch(trainer, loader)
    used = loader.sampler.used_ids["train"]
    for epoch in range(2):
        seen, losses = _recorded(de, epoch)
        assert len(seen) == de.n_steps == len(loader) and losses.shape == (de.n_steps,)
        w = np.concatenate([b["weight"] for b in seen])
        u = np.concatenate([b["user_id"] for b in seen])[w > 0]
        i = np.concatenate([b["item_id"] for b in seen])[w > 0]
        neg = np.concatenate([b["neg_item_id"] for b in seen])
        assert w.sum() == len(split)
        got = sorted(zip(u.tolist(), i.tolist()))
        assert got == sorted(zip(split.inter["user_id"].tolist(), split.inter["item_id"].tolist()))
        uu = np.concatenate([b["user_id"] for b in seen])
        assert (neg >= 1).all() and (neg < split.item_num).all()
        for a, b in zip(uu, neg):
            assert b not in used[a], (a, b)
    assert de.sparse_tables and de.sparse_impl == "pallas"


@pytest.mark.parametrize("branch", ["popularity", "repeatable"])
def test_epoch_sampler_branches(branch):
    """Popularity negatives come from the alias table, so only items with
    training interactions are drawn, none PAD or used; a repeatable sampler
    draws without the bitmap, so the heavy user meets its used items."""
    split = _toy()
    nsa = {"distribution": branch if branch == "popularity" else "uniform", "sample_num": 1}
    trainer, _ = _trainer(split, train_neg_sample_args=nsa)
    sampler = Sampler(["train"], [split], distribution=nsa["distribution"], seed=3,
                      repeatable=branch == "repeatable")
    loader = TrainBatcher(split, sampler, trainer.config, InputType.PAIRWISE)
    de = pde.DeviceEpoch(trainer, loader)
    assert (de.pop_tab is not None) is (branch == "popularity")
    assert (de.bitmap is None) is (branch == "repeatable")
    seen, _ = _recorded(de)
    u = np.concatenate([b["user_id"] for b in seen])
    neg = np.concatenate([b["neg_item_id"] for b in seen])
    used = sampler.used_ids["train"]
    hit = np.array([n in used[a] for a, n in zip(u, neg)])
    assert (neg >= 1).all()
    if branch == "popularity":
        assert np.isin(neg, split.inter["item_id"]).all() and not hit.any()
    else:
        assert hit[u == 1].any()


def test_oov_sub_epoch_flags_and_buckets():
    """Each kept step pads users, items or both; its buckets are the hashes
    of the ids before masking; a masked id carries no flag."""
    split = _toy()
    trainer, loader = _trainer(split)
    trainer.oov_simulator = OOVSimulator(trainer.model.spec, split.user_num, split.item_num,
                                         0.2, host_rng(1, "oov_regime"))
    de = pde.DeviceEpoch(trainer, loader, oov=True)
    seen, losses = _recorded(de)
    assert 0 < len(seen) <= de.n_steps
    assert int((losses != 0).sum()) == len(seen)
    spec = trainer.model.spec
    options = set()
    for b in seen:
        for f, n_orig, nb in (("user_id", split.user_num, spec.n_user_buckets),
                              ("item_id", split.item_num, spec.n_item_buckets)):
            live = b[f] != 0
            want = hash_ids(b[f] + PRIME - n_orig, nb, "3round")
            np.testing.assert_array_equal(b[f + "_bucket"][live], want[live])
            masked = ~live & (b["weight"] > 0)  # real ids are >= 1
            assert (b[f + "_oov"][masked] == 0).all()
        options.add((int(b["user_id_oov"].max()), int(b["item_id_oov"].max())))
        assert set(np.unique(b["user_id_oov"])) <= {0, 1}
    assert options <= {(0, 1), (1, 0), (1, 1)} and len(options) >= 2
    real = np.concatenate([b["weight"] for b in seen]) > 0
    masked = (np.concatenate([b["user_id"] for b in seen])[real] == 0).mean()
    assert 0.1 < masked < 0.3  # mask rate 0.2


def test_frozen_sub_epoch_moves_only_the_buckets():
    split = _toy()
    trainer, loader = _trainer(split, oov_freeze_embedding=True)
    trainer.oov_simulator = OOVSimulator(trainer.model.spec, split.user_num, split.item_num,
                                         0.2, host_rng(1, "oov_regime"))
    de = pde.DeviceEpoch(trainer, loader, oov=True, frozen=True)
    assert de.sparse_tables is None  # the sparse path is off, as in JAX
    before = {n: p.detach().clone() for n, p in trainer.params.items()}
    de.run(0)
    moved = {n for n, p in trainer.params.items() if not torch.equal(p, before[n])}
    assert moved == {"user_oov_buckets.weight", "item_oov_buckets.weight"}


def _fit(split, impl, **over):
    trainer, loader = _trainer(split, impl=impl, **over)
    trainer.fit(loader, None, saved=False)
    return trainer


@pytest.mark.parametrize("impl", ["auto", "xla"])
def test_sparse_epoch_matches_the_dense_lazy_sweep(impl):
    """Two epochs + OOV sub-epochs through `Trainer.fit` with the same
    generator seeds: the row-sparse path (kernel route and plain route)
    against `sparse_update_impl: dense`, to rtol 2e-5 / atol 2e-6."""
    split = _toy()
    sparse, dense = _fit(split, impl), _fit(split, "dense")
    des = list(sparse._device_epochs.values())
    assert len(des) == 2 and all(d.sparse_tables for d in des)
    assert {d.sparse_impl for d in des} == {"xla" if impl == "xla" else "pallas"}
    assert all(d.sparse_tables is None for d in dense._device_epochs.values())
    assert sparse._global_step == dense._global_step == 2 * 2 * len(des[0].weights) // 64
    for n, p in sparse.params.items():
        np.testing.assert_allclose(p.detach().numpy(), dense.params[n].detach().numpy(),
                                   rtol=2e-5, atol=2e-6, err_msg=n)
    for e in (0, 1):
        np.testing.assert_allclose(sparse.train_loss_dict[e], dense.train_loss_dict[e], rtol=1e-5)
        np.testing.assert_allclose(sparse.oov_loss_dict[e], dense.oov_loss_dict[e], rtol=1e-5)


def test_same_seed_same_tables_and_losses():
    split = _toy()
    a, b = _fit(split, "auto"), _fit(split, "auto")
    for n, p in a.params.items():
        assert torch.equal(p, b.params[n]), n
    assert a.train_loss_dict == b.train_loss_dict and a.oov_loss_dict == b.oov_loss_dict
    c = _fit(split, "auto", seed=12)
    assert not torch.equal(a.params["user_embedding.weight"], c.params["user_embedding.weight"])


class _FakeTrainer:
    mesh = None
    dhe_hasher = None

    class model:
        supports_device_epoch = True


@pytest.mark.parametrize("flag", [True, False, "auto", "auto-large"])
def test_eligibility_gates_match_jax(flag, monkeypatch):
    """`device_epoch_eligible` on the same loaders (pairwise, pointwise,
    plain) and flags gives the JAX package's answer; under `auto` at the
    row threshold too. The trainer then builds the device epoch of that
    mode wherever the gate lets it."""
    if flag == "auto-large":
        monkeypatch.setattr(jde, "AUTO_MIN_ROWS", 1)
        monkeypatch.setattr(pde, "AUTO_MIN_ROWS", 1)
    value = "auto" if flag == "auto-large" else flag
    answers = {}
    for mode in ("pairwise", "pointwise", "plain"):
        jcfg, jl, pl = _loaders(mode)
        jcfg["device_epoch"] = value
        pcfg = Config(dict(pl.config.as_dict(), device_epoch=value))
        want = jde.device_epoch_eligible(_FakeTrainer(), jl, jcfg)
        got = pde.device_epoch_eligible(_FakeTrainer(), pl, pcfg)
        assert got == want, mode
        answers[mode] = got
        _FakeTrainer.model.supports_device_epoch = False
        assert not pde.device_epoch_eligible(_FakeTrainer(), pl, pcfg)
        assert not jde.device_epoch_eligible(_FakeTrainer(), jl, jcfg)
        _FakeTrainer.model.supports_device_epoch = True
        if mode != "pairwise" and got:
            trainer = Trainer(pcfg, BPR(pl.split.user_num, pl.split.item_num, 8,
                                        InductiveSpec(), device="cpu"))
            de = trainer._maybe_device_epoch(pl)
            assert de is not None and de.mode == mode
    assert answers == {m: flag in (True, "auto-large") for m in answers}


@pytest.mark.parametrize("hash_function,buckets,device", [
    ("3round", 8, True), ("fast", 8, True), ("64bit", 65536, True), ("mod", 65537, False)])
def test_oov_sub_epoch_gates(hash_function, buckets, device):
    """The OOV sub-epoch runs on the device for the four hash functions and
    up to 2^16 buckets a side (`trainer.py:519-529`); beyond, the host path."""
    split = _toy(heavy=False)
    spec = dict(SPEC, hash_function=hash_function, n_user_buckets=buckets)
    cfg = Config(dict(seed=1, train_batch_size=64, learner="sparse_adam", device_epoch=True,
                      oov_train_ratio=1.0))
    model = BPR(split.user_num, split.item_num, 4, InductiveSpec(**spec), device="cpu")
    trainer = Trainer(cfg, model)
    loader = TrainBatcher(split, Sampler(["train"], [split], seed=1), cfg, InputType.PAIRWISE)
    trainer.oov_simulator = OOVSimulator(model.spec, split.user_num, split.item_num, 0.2,
                                         host_rng(1, "oov_regime"))
    assert trainer._maybe_device_epoch(loader) is not None
    de = trainer._maybe_device_epoch(loader, oov=True)
    assert (de is not None) is device
    if device:
        seen, _ = _recorded(de)
        b = seen[0]
        live = b["user_id"] != 0
        want = hash_ids(b["user_id"] + PRIME - split.user_num, buckets, hash_function)
        np.testing.assert_array_equal(b["user_id_bucket"][live], want[live])


# ------------------------------------------------------------- embedders


def _emb_trainer(split, embedder, impl="auto", **over):
    """`_trainer` with an embedder and a random state: unit feature rows,
    planes, neighbors and keys from a seed."""
    rng = np.random.default_rng(8)
    state = {}
    for side, n in (("user", split.user_num), ("item", split.item_num)):
        mat = rng.standard_normal((n, 5)).astype(np.float32)
        mat /= np.linalg.norm(mat, axis=1, keepdims=True)
        state[f"{side}_feat_mat"] = mat
        state[f"{side}_planes"] = rng.standard_normal((8, 5)).astype(np.float32)
        state[f"{side}_knn_neighbors"] = exact_knn_neighbors(mat, mat, 2)
    state["dhe_keys"] = rng.integers(0, 2**63, (4, 2)).astype(np.uint64)
    cfg = Config(dict(dict(
        seed=11, train_batch_size=64, learner="sparse_adam", learning_rate=1e-2, epochs=2,
        train_oov=True, oov_only_epoch=True, oov_train_ratio=0.8, oov_feature_mask_rate=0.2,
        device_epoch=True, sparse_update_impl=impl), **over))
    spec = InductiveSpec(embedder=embedder, add_oov_buckets=True, n_user_buckets=8,
                         n_item_buckets=8, dhe_num_hashes=4, dhe_layer_size=8)
    model = BPR(split.user_num, split.item_num, 8, spec, device="cpu",
                generator=torch_generator(5), embedder_state=state)
    sampler = Sampler(["train"], [split], seed=11)
    return Trainer(cfg, model), TrainBatcher(split, sampler, cfg, InputType.PAIRWISE)


@pytest.mark.parametrize("embedder", ["lsh", "slsh", "dnn", "knn", "zero", "mean"])
def test_embedders_take_the_device_epoch(embedder):
    """Two epochs + OOV sub-epochs on the device epoch; with lsh, slsh and
    dnn the sparse path (kernel 6's route and the plain route, bit for bit)
    equals the dense lazy sweep, as for the buckets; knn and mean read the
    whole table, so they take the dense sweep."""
    split = _toy()
    runs = {}
    for impl in ("auto", "xla", "dense"):
        trainer, loader = _emb_trainer(split, embedder, impl)
        trainer.fit(loader, None, saved=False)
        des = list(trainer._device_epochs.values())
        assert len(des) == 2 and trainer.oov_loss_dict
        sparse = embedder not in ("knn", "mean") and impl != "dense"
        assert all(bool(d.sparse_tables) == sparse for d in des), impl
        runs[impl] = trainer
    for n, p in runs["auto"].params.items():
        assert torch.equal(p, runs["xla"].params[n]), n
        np.testing.assert_allclose(p.detach().numpy(), runs["dense"].params[n].detach().numpy(),
                                   rtol=2e-5, atol=2e-6, err_msg=n)
    for e in (0, 1):
        np.testing.assert_allclose(runs["auto"].oov_loss_dict[e],
                                   runs["dense"].oov_loss_dict[e], rtol=1e-5)


@pytest.mark.parametrize("embedder", ["dhe", "fdhe"])
def test_dhe_keeps_off_the_device_epoch(embedder, monkeypatch):
    """Hashed on the host (`dhe_on_device: false`), DHE and fDHE fail the
    JAX package's `dhe_ok` gate: `device_epoch: true` and `auto` take the
    host path, which hashes each batch and trains."""
    split = _toy()
    trainer, loader = _emb_trainer(split, embedder)
    assert not trainer.dhe_hasher.on_device
    assert not pde.device_epoch_eligible(trainer, loader, trainer.config)
    assert trainer._maybe_device_epoch(loader) is None
    monkeypatch.setattr(pde, "AUTO_MIN_ROWS", 1)
    trainer, loader = _emb_trainer(split, embedder, device_epoch="auto", epochs=1)
    assert not pde.device_epoch_eligible(trainer, loader, trainer.config)
    assert trainer._maybe_device_epoch(loader) is None
    trainer.fit(loader, None, saved=False)
    assert not trainer._device_epochs and trainer.oov_loss_dict
