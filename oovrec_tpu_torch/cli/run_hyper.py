"""Hyper-parameter search entry.

    python -m oovrec_tpu_torch.cli.run_hyper --model=BPR --dataset=ml-1m \
        --params_file=bpr.hyper --algo=bayes --max_evals=50

Port of `oovrec_tpu/cli/run_hyper.py`, taking the same flags: `--algo`
exhaustive | random | bayes (`train/hyper_tuning.py`), `--max_evals`,
`--params_file` (the `.hyper` file), `--output_file` (each trial's
parameters and valid score, then the best), the TPE knobs `--n_startup`,
`--gamma` and `--n_candidates`; every other `--key=value` is fixed for
every trial. Each trial is `cli/quick_start.py:objective_function`, a
whole run on `--device` (the card unless the caller asks for the CPU).

`--tool=ray` hands the trials to ray.tune under an ASHA scheduler. ray is
an optional dependency: without it the entry exits at once with a message
that names it.
"""

from __future__ import annotations

import sys

from oovrec_tpu_torch.config import parse_cli_args
from oovrec_tpu_torch.train.hyper_tuning import HyperTuning, Parameter


def ray_tune(args, params_file, max_evals, metric="recall@10"):
    """The trials under ray.tune: each `.hyper` line a search-space entry,
    each trial the same objective, an ASHA scheduler on `metric`."""
    try:
        import ray  # noqa: PLC0415 — optional dependency
        from ray import tune
        from ray.tune.schedulers import ASHAScheduler
    except ImportError as e:
        raise SystemExit(
            "--tool=ray requires the ray wheel: pip install 'ray[tune]'. The built-in "
            f"exhaustive, random and bayes algos search without it. ({e})")
    from oovrec_tpu_torch.cli.quick_start import objective_function

    ray.init(ignore_reinit_error=True)
    space = {}
    with open(params_file) as f:
        for line in f:
            if not line.strip():
                continue
            p = Parameter.parse(line)
            if p.kind == "choice":
                space[p.name] = tune.choice(list(p.spec))
            elif p.kind == "uniform":
                space[p.name] = tune.uniform(*p.spec)
            elif p.kind == "quniform":
                space[p.name] = tune.quniform(*p.spec)
            elif p.kind == "loguniform":
                # the bounds as `Parameter.sample` reads them
                space[p.name] = tune.loguniform(*p.spec)

    def trainable(config):
        res = objective_function(config_dict={**args, **config}, saved=False)
        tune.report({**res["best_valid_result"], "best_valid_score": res["best_valid_score"]})

    scheduler = ASHAScheduler(metric=metric, mode="max", max_t=10, grace_period=1,
                              reduction_factor=2)
    return tune.run(trainable, config=space, num_samples=max_evals, scheduler=scheduler,
                    local_dir="./ray_log")


def main(argv=None):
    """Run the search; → the `HyperTuning` (ray.tune's result under ray)."""
    from oovrec_tpu_torch.cli.quick_start import objective_function

    args = parse_cli_args(argv if argv is not None else sys.argv[1:])
    params_file = args.pop("params_file", None)
    algo = args.pop("algo", "exhaustive")
    max_evals = int(args.pop("max_evals", 100))
    output_file = args.pop("output_file", "hyper_result.txt")
    tool = args.pop("tool", "builtin")
    if str(tool).lower() == "ray":
        return ray_tune(args, params_file, max_evals)

    tpe_kwargs = {k: t(args.pop(k)) for k, t in (("n_startup", int), ("gamma", float),
                                                 ("n_candidates", int)) if k in args}
    ht = HyperTuning(objective_function, algo=algo, params_file=params_file,
                     fixed_config_dict=args, max_evals=max_evals,
                     seed=int(args.get("seed", 2020)), **tpe_kwargs)
    ht.run()
    ht.export_result(output_file)
    print("best params:", ht.best_params)
    print("best valid score:", ht.best_score)
    print("test result of best run:", ht.best_test_result)
    return ht


if __name__ == "__main__":
    main()
