"""Hyper-parameter search over the `.hyper` file format.

Port of `oovrec_tpu/train/hyper_tuning.py`, numpy only: each trial
sequence is the JAX package's bit for bit for a seed and the same scores
(the stream is `host_rng(seed, "hyper_tuning")`, drawn in the same order).
A `.hyper` file holds one parameter a line, `<name> <kind> <spec>`, with
the kinds choice, uniform, loguniform and quniform. Three algorithms:
  * 'exhaustive': the full grid over choice parameters;
  * 'random': `max_evals` draws from the declared distributions;
  * 'bayes': a sequential TPE-style search. After `n_startup` random
    trials the observed trials split into a good (the top `gamma`
    quantile) and a bad group; each parameter gets a density per group (a
    smoothed categorical for choice, a Parzen mixture in the transformed
    space for the numeric kinds), `n_candidates` proposals are drawn from
    the good density, and the one with the largest log l(x)/g(x) runs next.

Each trial calls `objective_function(config_dict=..., config_file_list=...)`
(`cli/quick_start.py:objective_function`), and trials are compared on
`best_valid_score` in the direction of `valid_score_bigger`.
"""

from __future__ import annotations

import ast
import itertools
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from oovrec_tpu_torch.utils.seeding import host_rng


class Parameter:
    def __init__(self, name: str, kind: str, spec):
        self.name = name
        self.kind = kind
        self.spec = spec

    @staticmethod
    def parse(line: str) -> "Parameter":
        name, kind, rest = line.strip().split(" ", 2)
        return Parameter(name, kind, ast.literal_eval(rest.strip()))

    def sample(self, rng: np.random.Generator):
        if self.kind == "choice":
            return self.spec[int(rng.integers(0, len(self.spec)))]
        if self.kind == "uniform":
            lo, hi = self.spec
            return float(rng.uniform(lo, hi))
        if self.kind == "loguniform":
            lo, hi = self.spec
            return float(np.exp(rng.uniform(np.log(lo), np.log(hi))))
        if self.kind == "quniform":
            lo, hi, q = self.spec
            return float(np.round(rng.uniform(lo, hi) / q) * q)
        raise ValueError(f"Unknown parameter kind [{self.kind}]")

    def grid(self) -> List[Any]:
        if self.kind != "choice":
            raise ValueError(
                "Exhaustive search only supports 'choice' parameters "
                f"(got {self.kind} for {self.name})"
            )
        return list(self.spec)

    # ---- TPE helpers: numeric params model densities in a transformed
    # space (log for loguniform) so the Gaussian kernels are well-shaped

    def _bounds(self):
        lo, hi = self.spec[0], self.spec[1]
        if self.kind == "loguniform":
            return float(np.log(lo)), float(np.log(hi))
        return float(lo), float(hi)

    def _transform(self, x: float) -> float:
        return float(np.log(x)) if self.kind == "loguniform" else float(x)

    def _untransform(self, z: float):
        if self.kind == "loguniform":
            return float(np.exp(z))
        if self.kind == "quniform":
            q = self.spec[2]
            return float(np.round(z / q) * q)
        return float(z)


class HyperTuning:
    def __init__(
        self,
        objective_function: Callable[..., Dict[str, Any]],
        algo: str = "exhaustive",
        params_file: Optional[str] = None,
        params_dict: Optional[Dict[str, List[Any]]] = None,
        fixed_config_file_list: Optional[List[str]] = None,
        fixed_config_dict: Optional[Dict[str, Any]] = None,
        max_evals: int = 100,
        seed: int = 2020,
        n_startup: int = 8,
        gamma: float = 0.25,
        n_candidates: int = 32,
    ):
        self.objective_function = objective_function
        self.algo = algo
        self.max_evals = max_evals
        # TPE knobs (bayes only): random warmup size, good-quantile
        # fraction, proposals scored per sequential step
        self.n_startup = int(n_startup)
        self.gamma = float(gamma)
        self.n_candidates = int(n_candidates)
        self._bigger = True  # learned from the first objective result
        self.fixed_config_file_list = fixed_config_file_list
        self.fixed_config_dict = fixed_config_dict or {}
        self.rng = host_rng(seed, "hyper_tuning")

        self.params: List[Parameter] = []
        if params_file:
            with open(params_file) as f:
                for line in f:
                    if line.strip():
                        self.params.append(Parameter.parse(line))
        if params_dict:
            for k, v in params_dict.items():
                self.params.append(Parameter(k, "choice", list(v)))

        self.best_score = None
        self.best_params: Optional[Dict[str, Any]] = None
        self.best_test_result = None
        self.params_list: List[Dict[str, Any]] = []
        self.score_list: List[float] = []

    def _trials(self):
        if self.algo == "exhaustive":
            grids = [p.grid() for p in self.params]
            for combo in itertools.islice(
                itertools.product(*grids), self.max_evals
            ):
                yield dict(zip([p.name for p in self.params], combo))
        elif self.algo == "random":
            for _ in range(self.max_evals):
                yield {p.name: p.sample(self.rng) for p in self.params}
        elif self.algo == "bayes":
            # sequential: each yield sees the scores recorded by run()
            # for every previous trial
            for _ in range(self.max_evals):
                yield self._bayes_next()
        else:
            raise NotImplementedError(f"algo [{self.algo}] not supported")

    # ------------------------------------------------------------ TPE

    def _split_groups(self):
        """Observed trials → (good, bad) param-dict lists by score
        quantile (scores oriented larger-is-better)."""
        scores = np.array(
            [float("-inf") if s is None or s != s else float(s)
             for s in self.score_list]
        )
        if not self._bigger:
            scores = -scores
        order = np.argsort(-scores, kind="stable")
        n_good = max(1, int(np.ceil(self.gamma * len(scores))))
        good = [self.params_list[i] for i in order[:n_good]]
        bad = [self.params_list[i] for i in order[n_good:]]
        return good, bad or good

    @staticmethod
    def _choice_logratio(p: Parameter, value, good, bad) -> float:
        k = len(p.spec)

        def prob(group):
            n = sum(1 for t in group if t.get(p.name) == value)
            return (n + 1.0) / (len(group) + k)  # add-one smoothing

        return float(np.log(prob(good)) - np.log(prob(bad)))

    def _numeric_kde(self, p: Parameter, group):
        """(centers, sigmas) of the Parzen mixture for one group: observed
        values in transformed space (per-center bandwidth shrinking as
        observations accumulate) plus a wide prior center that keeps the
        density positive everywhere."""
        lo, hi = p._bounds()
        obs = [p._transform(t[p.name]) for t in group if p.name in t]
        n = len(obs)
        centers = np.asarray(obs + [0.5 * (lo + hi)])
        sig_obs = max((hi - lo) / max(n, 1), 1e-12)
        sigmas = np.full(len(centers), sig_obs)
        sigmas[-1] = max(hi - lo, 1e-12)  # prior stays wide
        return centers, sigmas, lo, hi

    def _numeric_sample(self, p: Parameter, good):
        centers, sigmas, lo, hi = self._numeric_kde(p, good)
        i = int(self.rng.integers(0, len(centers)))
        z = float(np.clip(self.rng.normal(centers[i], sigmas[i]), lo, hi))
        return p._untransform(z)

    def _numeric_logratio(self, p: Parameter, value, good, bad) -> float:
        z = p._transform(value)

        def logdens(group):
            centers, sigmas, lo, hi = self._numeric_kde(p, group)
            d = np.exp(-0.5 * ((z - centers) / sigmas) ** 2) / sigmas
            return float(np.log(np.mean(d) + 1e-300))

        return logdens(good) - logdens(bad)

    def _bayes_next(self) -> Dict[str, Any]:
        """One TPE step. The posterior factorizes over parameters, so each
        parameter is optimized INDEPENDENTLY (as hyperopt does): draw
        `n_candidates` values from that parameter's good-group density and
        keep the one maximizing log l(x)/g(x). A joint argmax would let
        the continuous dimensions' log-ratios swamp the categorical
        signal and lock choices in on the warmup draws."""
        if len(self.score_list) < self.n_startup:
            return {p.name: p.sample(self.rng) for p in self.params}
        # ε-exploration: an occasional pure-prior trial bounds the regret
        # of a density estimate gone confidently wrong
        if self.rng.random() < 0.05:
            return {p.name: p.sample(self.rng) for p in self.params}
        good, bad = self._split_groups()
        cand: Dict[str, Any] = {}
        for p in self.params:
            if p.kind == "choice":
                # exhaustive over the (small) categorical support: pick
                # the value maximizing the smoothed count ratio. With
                # prob 0.2 draw uniformly instead — pairing an untried
                # category with the CONVERGED continuous coordinates is
                # the only way a weak categorical effect ever surfaces
                # (a full-prior redraw buries it in continuous noise).
                if self.rng.random() < 0.20:
                    cand[p.name] = p.spec[
                        int(self.rng.integers(0, len(p.spec)))
                    ]
                else:
                    cand[p.name] = max(
                        p.spec,
                        key=lambda v: self._choice_logratio(p, v, good, bad),
                    )
                continue
            best_v, best_s = None, -np.inf
            for _ in range(self.n_candidates):
                v = self._numeric_sample(p, good)
                s = self._numeric_logratio(p, v, good, bad)
                if s > best_s:
                    best_v, best_s = v, s
            cand[p.name] = best_v
        return cand

    def run(self) -> None:
        for trial in self._trials():
            cfg = {**self.fixed_config_dict, **trial}
            result = self.objective_function(
                config_dict=cfg, config_file_list=self.fixed_config_file_list
            )
            score = result["best_valid_score"]
            bigger = result.get("valid_score_bigger", True)
            self._bigger = bigger  # orient the TPE quantile split
            self.params_list.append(trial)
            self.score_list.append(score)
            better = (
                self.best_score is None
                or (bigger and score > self.best_score)
                or (not bigger and score < self.best_score)
            )
            if better:
                self.best_score = score
                self.best_params = trial
                self.best_test_result = result.get("test_result")

    def export_result(self, output_file: str) -> None:
        with open(output_file, "w") as f:
            for p, s in zip(self.params_list, self.score_list):
                f.write(f"{p}  valid_score: {s}\n")
            f.write(f"\nbest params: {self.best_params}\n")
            f.write(f"best score: {self.best_score}\n")
