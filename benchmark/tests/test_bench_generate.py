"""The generator repeats per seed, and another seed draws the same sizes."""

import numpy as np
import torch

from benchmark.harness import generate, manifest, weights

BIG = 2**31 + 12345  # seeds may pass 32 signed bits


def small_corpus():
    c = manifest.config("bpr-d64-1m")["corpus"]
    c.update(n_old_users=500, n_new_users=50, n_old_items=3000, n_new_items=300,
             train_interactions=30_000)
    return c


def test_interactions_repeat_per_seed():
    c = small_corpus()
    a, b = generate.interactions(c, BIG), generate.interactions(c, BIG)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    other = generate.interactions(c, BIG + 1)
    assert len(other[0]) == len(a[0]) == c["train_interactions"]
    assert not np.array_equal(other[1], a[1])
    users, items = a
    counts = np.bincount(users)[1:]
    assert counts.min() >= c["min_per_user"] and users.min() >= 1
    assert items.min() >= 1 and items.max() < c["n_old_items"]


def test_ctr_rows_repeat_per_seed():
    c = manifest.config("xdeepfm-ml1m")["corpus"]
    c.update(n_old_users=300, n_new_users=40, n_old_items=200, n_new_items=30, rows=20000,
             positive_rows=11500)
    r1, u1, i1 = generate.ctr_rows(c, BIG)
    r2, u2, i2 = generate.ctr_rows(c, BIG)
    assert all(np.array_equal(r1[k], r2[k]) for k in r1)
    assert all(np.array_equal(u1[k], u2[k]) for k in u1)
    assert abs(r1["label"].mean() - 11500 / 20000) < 1e-3
    counts = np.bincount(r1["user_id"], minlength=340)[1:]
    assert counts.min() >= c["min_per_user"] and counts.sum() == 20000
    for table, fields in ((u1, c["schema"]["user_features"]), (i1, c["schema"]["item_features"])):
        for f in fields:
            assert table[f][0] == 0 and table[f][1:].min() >= 1


def test_eval_users_repeat_and_hold_their_laws():
    c = small_corpus()
    mix = manifest.traffic("eval-7slice")
    mix.update(test_users=200)
    near = lambda users: np.tile(np.arange(1, 49), (len(users), 1))  # noqa: E731
    a = generate.eval_users(c, mix, BIG, near)
    b = generate.eval_users(c, mix, BIG, near)
    assert np.array_equal(a[0], b[0])
    assert all(np.array_equal(x, y) for x, y in zip(a[1] + a[2], b[1] + b[2]))
    users, pos, hist = a
    assert len(users) == 200 and (users >= c["n_old_users"]).sum() == 20
    for p, h in zip(pos, hist):
        assert 1 <= len(p) <= mix["max_positives"] and len(h) <= mix["max_history"]
        assert len(set(p) | set(h)) == len(p) + len(h)  # no repeats, disjoint


def test_weights_repeat_per_seed():
    shapes = {"a.weight": (30, 4), "a.bias": (4,)}
    w1 = weights.make(shapes, BIG, torch.device("cpu"))
    w2 = weights.make(shapes, BIG, torch.device("cpu"))
    assert torch.equal(w1["a.weight"], w2["a.weight"]) and not w1["a.bias"].any()
