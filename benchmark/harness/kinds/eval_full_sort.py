"""The evaluation cells: passes of the port's `InductiveEvaluator`.

Set-up makes the model's weights and the test users (their positives and
histories) from the seed, builds the port's batcher and evaluator, and runs
one whole pass, which builds the kernels and the evaluator's step. The window
then runs passes back to back until `--seconds` have passed. The batcher is
wrapped, not edited: each batch's latency runs from the evaluator taking it to
its taking the next (or the pass's return), and in a traced run its
`__next__` is a span. The evaluator's step is wrapped to keep each batch's
four rankings; once the window has closed, the reference judges them
(`reference/retrieval.py`).
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark.harness import generate, models, weights
from benchmark.harness.profiling import span, traced
from benchmark.reference import bpr as ref_bpr
from benchmark.reference import retrieval

NEAR = 24  # a user's best old and best new items, the pool of near positives


class TimedLoader:
    """The port's batcher, with the time at which each batch was taken."""

    def __init__(self, loader, spans: bool):
        self._loader = loader
        self.spans = spans
        self.latencies: List[float] = []
        self.batcher_s: List[float] = []

    def __getattr__(self, name):
        return getattr(self._loader, name)

    def __len__(self):
        return len(self._loader)

    def __iter__(self):
        it = iter(self._loader)
        takes = []
        while True:
            t = time.perf_counter()
            with span("batcher", self.spans):
                batch = next(it, None)
            taken = time.perf_counter()
            if batch is None:
                break
            self.batcher_s.append(taken - t)
            takes.append(taken)
            yield batch
        # the last batch ends where the pass returns: `end_pass` closes it
        self._open = takes

    def end_pass(self, end: float) -> None:
        t = self._open + [end]
        self.latencies.extend(b - a for a, b in zip(t[:-1], t[1:]))


class Answers:
    """Keeps the rankings each batch's step produced, pass by pass."""

    def __init__(self, evaluator):
        self.passes: List[List[dict]] = []
        self._step = evaluator._step
        evaluator._step = self.step

    def new_pass(self):
        self.passes.append([])

    def step(self, db, *args):
        out = self._step(db, *args)
        self.passes[-1].append({"users": db["user_id"], "weight": db["weight"],
                                "ranks": {v: out[v][0] for v in retrieval.VARIANTS}})
        return out


def port_config(cfg: dict, mix: dict, seed: int, n_items: int):
    from oovrec_tpu_torch.config import Config

    return Config({**cfg["port"], **mix["port"], "seed": int(seed),
                   "eval_batch_size": mix["users_per_batch"] * n_items})


def near_items(w, spec: dict, device):
    """users → (U, 2 NEAR) the best old and the best new items for each
    user under the weights (the reference's routing)."""
    items = ref_bpr.item_matrix(w, spec, device)
    n_old = spec["n_old_items"]

    def near(users: np.ndarray) -> np.ndarray:
        out = []
        for lo in range(0, len(users), retrieval.USER_BLOCK):
            u = ref_bpr.user_vectors(w, users[lo:lo + retrieval.USER_BLOCK], spec, device)
            s = u @ items.T
            old = torch.topk(s[:, 1:n_old], NEAR, dim=1).indices + 1
            new = torch.topk(s[:, n_old:], NEAR, dim=1).indices + n_old
            out.append(torch.cat([old, new], dim=1).cpu().numpy())
        return np.concatenate(out)

    return near


def run(cell, seed: int, seconds: float, trace: bool, device, clock,
        controls=()) -> dict:
    """One run; each of `controls` ('tf32') also reads the numbers of the
    reference put in the program's place in that precision, under
    `control_checks`."""
    from oovrec_tpu_torch.data.dataloader import FullSortEvalBatcher
    from oovrec_tpu_torch.data.dataset import DatasetSplit
    from oovrec_tpu_torch.data.sampler import Sampler
    from oovrec_tpu_torch.eval.inductive import InductiveEvaluator
    from oovrec_tpu_torch.inductive.mapper import RandomOOVMapper

    cfg, mix = cell.config, cell.traffic
    c = cfg["corpus"]
    spec = models.spec_of(cfg)
    n_users = c["n_old_users"] + c["n_new_users"]
    n_items = c["n_old_items"] + c["n_new_items"]
    adapter = models.adapter(cfg)
    model = adapter.build(device)
    w = weights.make(models.weight_shapes(model), seed, device)
    weights.load_into(model, w)
    clock.mark("model")
    users, positives, histories = generate.eval_users(c, mix, seed, near_items(w, spec, device))
    clock.mark("test users")

    def split(lists):
        return DatasetSplit({"user_id": np.repeat(users, [len(x) for x in lists]),
                             "item_id": np.concatenate(lists)}, n_users, n_items)

    port_cfg = port_config(cfg, mix, seed, n_items)
    hist, test = split(histories), split(positives)
    loader = TimedLoader(FullSortEvalBatcher(test, Sampler(["train", "test"], [hist, test],
                                                            seed=seed), port_cfg, phase="test"),
                         trace)
    mapper = RandomOOVMapper(model.spec, c["n_old_users"], c["n_old_items"], n_users, n_items)
    mapper.set_eval()
    ev = InductiveEvaluator(model, port_cfg, c["n_old_users"], c["n_old_items"], mapper=mapper)
    clock.mark("batcher and evaluator")
    ev.evaluate_model(loader)  # builds the kernels and the evaluator's step
    clock.mark("first pass")
    answers = Answers(ev)
    loader.latencies.clear()
    loader.batcher_s.clear()
    results = []

    def one_pass():
        answers.new_pass()
        with span("pass", trace):
            results.append(ev.evaluate_model(loader))
        loader.end_pass(time.perf_counter())

    out = {"setup_s": clock.since_start()}
    if trace:
        def stretch():
            # a take of the trace that lost records runs again
            answers.passes.clear()
            results.clear()
            loader.latencies.clear()
            loader.batcher_s.clear()
            for _ in range(mix["trace_passes"]):
                one_pass()
        out["trace"] = traced(stretch, device)
        wall = out["trace"].wall_s
    else:
        t0 = time.perf_counter()
        while True:
            one_pass()
            if time.perf_counter() - t0 >= seconds:
                break
        wall = time.perf_counter() - t0
    scored = sum(int((b["weight"] > 0).sum()) for p in answers.passes for b in p)
    out.update(wall_s=wall, users=scored, batches=len(loader.latencies),
               latencies=list(loader.latencies), batcher_s=list(loader.batcher_s),
               attempted=scored, failed=0,
               memory_peak_bytes=clock.memory_peak(device))

    del ev, model, loader, mapper
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    out["checks"] = check(answers.passes, results, w, users, positives, histories, spec,
                          port_cfg, seed, device)
    out["control_checks"] = {}
    for c in controls:
        ranks = control_ranks(answers.passes, w, users, histories, spec, seed, device, c)
        out["control_checks"][c] = check(answers.passes, results, w, users, positives,
                                         histories, spec, port_cfg, seed, device,
                                         control_ranks=ranks)
    return out


def control_ranks(passes, w, users, histories, spec, seed, device, control: str):
    """The judged passes' rankings as the reference gives them with its
    products in `control`'s precision (TF32), each user's history left out,
    in the order the program scored the users."""
    if control != "tf32":
        raise ValueError(f"no control {control!r}")
    where = {int(u): r for r, u in enumerate(users)}
    out = []
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        items = ref_bpr.item_matrix(w, spec, device)
        n, n_old = items.shape[0], spec["n_old_items"]
        for p in judged_passes(len(passes), seed):
            got_users, ranks = pass_answers(passes[p])
            k = ranks["overall"].shape[1]
            rows = [where[int(u)] for u in got_users]
            mine = {v: [] for v in retrieval.VARIANTS}
            for lo in range(0, len(rows), retrieval.USER_BLOCK):
                block = rows[lo:lo + retrieval.USER_BLOCK]
                s = ref_bpr.user_vectors(w, users[block], spec, device) @ items.T
                for r, row in enumerate(block):
                    s[r, torch.as_tensor(histories[row], dtype=torch.long, device=device)] = \
                        -float("inf")
                for v in retrieval.VARIANTS:
                    a, b = retrieval.variant_range(v, n_old, n)
                    mine[v].append(torch.topk(s[:, a:b], k, dim=1).indices + a)
            out.append({v: torch.cat(t) for v, t in mine.items()})
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    return out


def judged_passes(n: int, seed: int) -> List[int]:
    """The last pass and up to two others, drawn from the seed."""
    rest = np.random.default_rng(int(seed) + 7).permutation(n - 1)[:2] if n > 1 else []
    return sorted({n - 1, *[int(i) for i in rest]})


def pass_answers(record: List[dict]):
    """A pass's users and rankings, in the order it scored them (padding
    rows left out)."""
    keep = [b["weight"].cpu().numpy() > 0 for b in record]
    users = np.concatenate([b["users"].cpu().numpy()[k] for b, k in zip(record, keep)])
    ranks = {v: torch.cat([b["ranks"][v][torch.from_numpy(k).to(b["ranks"][v].device)]
                           for b, k in zip(record, keep)])
             for v in retrieval.VARIANTS}
    return users, ranks


def check(passes, results, w, users, positives, histories, spec, port_cfg, seed, device,
          control_ranks=None) -> Dict[str, float]:
    """`topk_gap` over the judged passes, `slices_off` of the last pass.
    `control_ranks`: rankings that stand in for the program's (a control),
    one dict per judged pass."""
    items = ref_bpr.item_matrix(w, spec, device)
    where = {int(u): r for r, u in enumerate(users)}
    gap, off = 0.0, 0
    judged = judged_passes(len(passes), seed)
    for j, p in enumerate(judged):
        got_users, ranks = pass_answers(passes[p])
        if control_ranks is not None:
            ranks = control_ranks[j]
        rows = [where.get(int(u), -1) for u in got_users]
        if sorted(rows) != list(range(len(users))):  # each test user once
            off += 1
            rows = [r for r in rows if r >= 0]
        u_e = ref_bpr.user_vectors(w, users[rows], spec, device)
        gap = max(gap, retrieval.topk_gap(u_e, items, [histories[r] for r in rows],
                                          ranks, spec["n_old_items"]))
        if p == len(passes) - 1 and control_ranks is None:
            ref = retrieval.slice_results(
                users[rows], {v: t.cpu().numpy() for v, t in ranks.items()},
                [positives[r] for r in rows], spec["n_old_users"], spec["n_old_items"],
                port_cfg["topk"], port_cfg["metrics"])
            off += retrieval.slices_off(results[p], ref)
    return {"topk_gap": gap, "slices_off": float(off)}
