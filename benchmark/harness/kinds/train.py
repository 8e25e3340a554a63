"""The training cells: whole epochs of the port's `Trainer.fit`.

Set-up builds one trainer (model, optimizer state, loader) from the seed and
runs its first epoch (the normal epoch and the OOV sub-epoch), which captures
every step's CUDA graph, through the same `fit` and loader as the window.
Every step of that epoch is recorded on the way (`Recorder`): the batch it
took, its loss, the optimizer's first moment after the first two steps of
each stage, and the state at the edges of the stages. The window then runs
whole epochs until `--seconds` have passed; once it has closed and the
program's state is freed, the reference follows the whole recorded epoch
(`reference/training.py`), as the mix's `follow` says: `chain`, from the
benchmark's weights along its own state; `per_step`, each step from the
program's state before it (recorded too). The recorded batches are also
checked against the benchmark's own data (`data_checks`).
"""

from __future__ import annotations

import gc
import time
from typing import Dict, Optional

import torch

from benchmark.harness import models, weights
from benchmark.harness.profiling import span, traced
from benchmark.reference import training as ref_training

STAGES = ("iv", "oov")


def stage_of(batch: Dict[str, torch.Tensor]) -> str:
    """A step of the OOV simulation carries its flags."""
    return "oov" if any(k.endswith("_oov") for k in batch) else "iv"


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.detach().clone() if isinstance(tree, torch.Tensor) else tree


class Recorder:
    """Records every step of one epoch through the trainer's step call: each
    stage's batches and losses, its first moments after its first and second
    steps, and the params, moments and count at the OOV sub-epoch's start
    (the normal epoch's end); `finish` takes the params at the epoch's end.
    `per_step`: the state before every step as well (`states`), and after
    the last (`after`)."""

    def __init__(self, trainer, per_step: bool = False):
        self.trainer, self.per_step = trainer, per_step
        self.stages = {s: {"batches": [], "losses": [], "states": []} for s in STAGES}
        self._last = None
        self._step = trainer.step_graphs.step
        trainer.step_graphs.step = self.step

    def _state(self) -> dict:
        t = self.trainer
        return {"params": _clone(t.params), "mu": _clone(t.opt_state["mu"]),
                "nu": _clone(t.opt_state["nu"]), "count": int(t.opt_state["count"])}

    def step(self, batch, trainable=None):
        t = self.trainer
        s = stage_of(batch)
        st = self.stages[s]
        i = len(st["batches"])
        if self.per_step:
            state = self._state()
            st["states"].append(state)
            if i == 0 and self._last is not None:
                self.stages[self._last]["after"] = state
            self._last = s
        if i == 0 and s == "oov":
            st["start"] = st["states"][0] if self.per_step else self._state()
        elif i in (1, 2):
            st[f"mu{i}"] = _clone(t.opt_state["mu"])
        st["batches"].append(_clone(batch))
        loss = self._step(batch, trainable)
        st["losses"].append(_clone(loss))
        return loss

    def finish(self):
        del self.trainer.step_graphs.step  # the class's own method again
        short = [s for s, st in self.stages.items() if len(st["batches"]) < 3]
        if short:
            raise RuntimeError(f"the first epoch ran fewer than 3 steps in {short}")
        if self.per_step:
            self.stages[self._last]["after"] = self._state()
        self.stages["oov"]["end"] = _clone(self.trainer.params)
        for st in self.stages.values():
            st["losses"] = [float(x) for x in st["losses"]]


class Counter:
    """The window's steps and rows, counted around the trainer's step call;
    in a traced run each step is a span."""

    def __init__(self, trainer, spans: bool):
        self.trainer, self.spans = trainer, spans
        self.reset()
        self._step = trainer.step_graphs.step
        trainer.step_graphs.step = self.step

    def reset(self):
        self.steps = {s: 0 for s in STAGES}
        self.rows = 0

    def step(self, batch, trainable=None):
        self.steps[stage_of(batch)] += 1
        self.rows += int(batch["weight"].shape[0])
        with span("step", self.spans):
            return self._step(batch, trainable)

    def close(self):
        del self.trainer.step_graphs.step


def port_config(cfg: dict, mix: dict, seed: int):
    from oovrec_tpu_torch.config import Config

    return Config({**cfg["port"], **mix["port"], "seed": int(seed), "log_tensorboard": False})


def run(cell, seed: int, seconds: float, trace: bool, device, clock,
        controls=()) -> dict:
    """One run; each of `controls` also reads the numbers of a side put in
    the program's place: the reference in a lower precision ('tf32',
    'bf16'), or a planted fault ('half': half of each batch left out;
    'unchecked_negs': negatives drawn without the used-pair check), under
    `control_checks`."""
    cfg, mix = cell.config, cell.traffic
    from oovrec_tpu_torch.train import Trainer

    adapter = models.adapter(cfg)
    port_cfg = port_config(cfg, mix, seed)
    loader = adapter.train_loader(seed, port_cfg, mix)
    clock.mark("data")
    model = adapter.build(device)
    w = weights.make(models.weight_shapes(model), seed, device)
    weights.load_into(model, w)
    trainer = Trainer(port_cfg, model)
    clock.mark("model and trainer")

    def epoch(e: int):
        trainer.start_epoch, trainer.epochs = e, e + 1
        with span("epoch", trace):
            trainer.fit(loader, None, saved=False)

    rec = Recorder(trainer, per_step=mix.get("follow") == "per_step")
    epoch(0)
    rec.finish()
    clock.mark("first epoch")
    out = {"setup_s": clock.since_start()}

    counter = Counter(trainer, trace)
    e = 1
    if trace:
        def stretch():
            nonlocal e
            counter.reset()  # a take of the trace that lost records runs again
            for _ in range(mix["trace_epochs"]):
                epoch(e)
                e += 1
        out["trace"] = traced(stretch, device)
        wall = out["trace"].wall_s
    else:
        t0 = time.perf_counter()
        while True:
            epoch(e)
            e += 1
            if time.perf_counter() - t0 >= seconds:
                break
        wall = time.perf_counter() - t0
    counter.close()
    out.update(steps=counter.steps, rows=counter.rows, wall_s=wall,
               attempted=sum(counter.steps.values()), failed=0,
               memory_peak_bytes=clock.memory_peak(device))
    out["recorded"] = {s: rec.stages[s]["batches"][:3] for s in STAGES}

    del trainer, model, loader, counter
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    out["checks"] = dict(data_checks(adapter, rec, cfg),
                         **reference_numbers(adapter, rec, w, seed, mix, device))
    out["control_checks"] = {}
    for c in controls:
        got = data_checks(adapter, rec, cfg, control=c, seed=seed)
        if c != "unchecked_negs":  # a fault of the data alone: the steps are the program's
            got.update(reference_numbers(adapter, rec, w, seed, mix, device, c))
        out["control_checks"][c] = got
    return out


def data_checks(adapter, rec: Recorder, cfg: dict, control: Optional[str] = None,
                seed: int = 0) -> Dict[str, float]:
    """The recorded epoch against the configuration and the benchmark's
    data: `oov.keep_share`, the OOV sub-epoch's steps over the normal
    epoch's, as a relative gap from `oov_train_ratio` (a Bernoulli keep per
    batch); `oov.mask_share`, the share of zeroed entries among the weighted
    rows' id columns (and row features) in the simulated steps, as a
    relative gap from `oov_feature_mask_rate`; and the model's own
    (`Adapter.checks`)."""
    p = cfg["port"]
    stages = rec.stages
    if control == "unchecked_negs":
        stages = {s: dict(st, batches=adapter.unchecked_negatives(st["batches"], seed))
                  for s, st in stages.items()}
    ratio, rate = float(p["oov_train_ratio"]), float(p["oov_feature_mask_rate"])
    n_iv, n_oov = (len(stages[s]["batches"]) for s in STAGES)
    zeros = entries = 0
    for b in stages["oov"]["batches"]:
        w = b["weight"].cpu().numpy() > 0
        for col in adapter.masked_columns:
            v = b[col].cpu().numpy()[w]
            zeros += int((v == 0).sum())
            entries += v.size
    out = {"oov.keep_share": abs(n_oov / n_iv - ratio) / ratio,
           "oov.mask_share": abs(zeros / max(entries, 1) - rate) / rate}
    out.update(adapter.checks(stages))
    return out


def _generator(adapter, seed: int, device) -> Optional[torch.Generator]:
    """The dropout masks' generator at the epoch's start: seeded with
    seed + 101, as the program's trainer seeds its own."""
    if not adapter.dropout:
        return None
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) + 101)
    return g


def _program_stage(st: dict, start_params, mu0, end_params) -> dict:
    g1, g2 = ref_training.moment_grads(mu0, st["mu1"], st["mu2"])
    return {"losses": st["losses"], "g1": g1, "g2": g2, "params0": start_params,
            "params": end_params}


def reference_numbers(adapter, rec: Recorder, w, seed: int, mix: dict, device,
                      control: Optional[str] = None) -> Dict[str, float]:
    """Each stage's numbers (`reference/training.py`). The reference follows
    the normal epoch from the benchmark's weights `w`, then the OOV
    sub-epoch from its own state. `control`: None (the program's recorded
    epoch is judged), or a side put in the program's place, which follows
    the same batches from the same start along its own chain."""
    if rec.per_step:
        return forced_numbers(adapter, rec, w, seed, mix, device, control)
    loss_fn, kw = adapter.reference_loss()
    lr = float(mix["port"]["learning_rate"])
    stages = rec.stages
    batches = {s: [adapter.reference_batch(b, s) for b in stages[s]["batches"]] for s in STAGES}
    ref_gen = _generator(adapter, seed, device)
    ref_start = ref_training.fresh(w)
    side_gen = _generator(adapter, seed, device)
    side_start = ref_training.fresh(w)
    numbers = {}
    for s in STAGES:
        ref = ref_training.follow(loss_fn, ref_start, batches[s], lr, generator=ref_gen, **kw)
        if control is None:
            st = stages[s]
            if s == "iv":
                side = _program_stage(st, w, None, stages["oov"]["start"]["params"])
            else:
                side = _program_stage(st, st["start"]["params"], st["start"]["mu"], st["end"])
        else:
            side = _control_follow(loss_fn, kw, side_start, batches[s], lr, side_gen, control)
            side_start = {"params": side["params"], "state": side["state"]}
        for k, v in ref_training.stage_numbers(side, ref).items():
            numbers[f"{s}.{k}"] = v
        ref_start = {"params": ref["params"], "state": ref["state"]}
        del ref
    return numbers


def _control_follow(loss_fn, kw, start, batches, lr, gen, control: str) -> dict:
    """A side in the program's place over one stage (see `run`)."""
    if control == "tf32":
        old = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            return ref_training.follow(loss_fn, start, batches, lr, generator=gen, **kw)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = old
    if control == "bf16":
        return ref_training.follow(loss_fn, start, batches, lr, generator=gen,
                                   dtype=torch.bfloat16, **kw)
    if control == "half":  # half of each batch left out, the mean over the rest
        halved = []
        for b in batches:
            wt = b["weight"].clone()
            wt[wt.shape[0] // 2:] = 0
            halved.append(dict(b, weight=wt))
        return ref_training.follow(loss_fn, start, halved, lr, generator=gen, **kw)
    raise ValueError(f"no control {control!r}")


def forced_numbers(adapter, rec: Recorder, w, seed: int, mix: dict, device,
                   control: Optional[str] = None) -> Dict[str, float]:
    """The reference step by step from the program's own state (the mix's
    `follow: per_step`): for each stage the widest gap over its steps of
    each of `reference/training.py:step_numbers`, and `iv.start_off`, the
    largest difference between the program's params before its first step
    and the benchmark's weights. `control`: a side put in the program's
    place, from the same states, with its own chain of dropout draws."""
    loss_fn, kw = adapter.reference_loss()
    lr = float(mix["port"]["learning_rate"])
    ref_gen = _generator(adapter, seed, device)
    side_gen = _generator(adapter, seed, device)
    first = rec.stages["iv"]["states"][0]["params"]
    numbers = {"iv.start_off": max(float((first[n] - w[n]).abs().max()) for n in w)}
    for s in STAGES:
        st = rec.stages[s]
        states = st["states"] + [st["after"]]
        worst: Dict[str, float] = {}
        for i, b in enumerate(st["batches"]):
            batch = adapter.reference_batch(b, s)
            ref = ref_training.reference_step(loss_fn, states[i], batch, lr, generator=ref_gen,
                                              **kw)
            if control is None:
                side = (st["losses"][i], *ref_training.program_step(states[i], states[i + 1]))
            else:
                side = _control_step(loss_fn, kw, states[i], batch, lr, side_gen, control)
            for k, v in ref_training.step_numbers(side, ref).items():
                worst[k] = max(worst.get(k, 0.0), v)
        numbers.update({f"{s}.{k}": v for k, v in worst.items()})
    return numbers


def _control_step(loss_fn, kw, state, batch, lr, gen, control: str):
    """A side in the program's place over one step from the program's state."""
    if control == "tf32":
        old = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            return ref_training.reference_step(loss_fn, state, batch, lr, generator=gen, **kw)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = old
    if control == "bf16":
        return ref_training.reference_step(loss_fn, state, batch, lr, generator=gen,
                                           dtype=torch.bfloat16, **kw)
    if control == "half":
        wt = batch["weight"].clone()
        wt[wt.shape[0] // 2:] = 0
        return ref_training.reference_step(loss_fn, state, dict(batch, weight=wt), lr,
                                           generator=gen, **kw)
    raise ValueError(f"no control {control!r}")
