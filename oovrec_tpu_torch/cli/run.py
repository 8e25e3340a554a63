"""Paper CLI driver: `python -m oovrec_tpu_torch.cli.run --model=BPR --dataset=...`.

Port of `oovrec_tpu/cli/run.py`, taking the same flags:
  * `--key=value` args with type inference (`config.parse_cli_args`);
  * the paper's eval protocol per `model_eval_type` (retrieval →
    Recall/MRR/NDCG/Hit/Precision with valid MRR@20; ranking → AUC/RMSE
    with valid RMSE; both with split RS [0.88, 0.02, 0.1], order TO, mode
    uni250, topk [10, 20], eval batches of 1e5 rows, uniform 1-negative
    sampling);
  * the per-dataset JSON (`dataset_configs/<ds>.json`), command line first;
  * train → checkpoint → weight backup → test eval → optional inductive
    eval, and `--results_json`;
  * `--eval_only=<checkpoint>`: the saved run's test eval (and inductive
    eval) without training.
Add `--device=cpu` to run on the CPU; the default is the card.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
from typing import Any, Dict

from oovrec_tpu_torch.config import parse_cli_args


def apply_paper_protocol(args: Dict[str, Any]) -> Dict[str, Any]:
    """The paper driver's eval-protocol overrides."""
    met = args.get("model_eval_type", "retrieval")
    if met == "retrieval":
        args["valid_metric"] = "MRR@20"
        args["metrics"] = ["Recall", "MRR", "NDCG", "Hit", "Precision"]
    elif met == "ranking":
        args["valid_metric"] = "RMSE"
        args["metrics"] = ["AUC", "RMSE"]
    else:
        raise NotImplementedError(f"Unknown model type: {met}")
    args["eval_args"] = {
        "split": {"RS": [0.88, 0.02, 0.1]},
        "group_by": None,
        "order": "TO",
        "mode": "uni250",
    }
    args["eval_batch_size"] = int(1e5)
    args["topk"] = [10, 20]
    neg = {
        "distribution": "uniform", "sample_num": 1, "alpha": 1.0,
        "dynamic": False, "candidate_num": 0,
    }
    args["train_neg_sample_args"] = dict(neg)
    args["oov_neg_sample_args"] = dict(neg)
    args["test_neg_sample_args"] = dict(neg)
    args["threshold"] = args.get("threshold")
    args["reproducibility"] = True
    return args


def merge_dataset_config(args: Dict[str, Any],
                         config_dir: str = "./dataset_configs") -> Dict[str, Any]:
    """Merge `<config_dir>/<dataset>.json` under the command line's args."""
    path = os.path.join(config_dir, f"{args.get('dataset')}.json")
    if os.path.exists(path):
        print("Dataset config file found:", path)
        with open(path, "rb") as f:
            base = json.load(f)
        return {**base, **args}
    print("Dataset config file not found, using defaults...")
    return args


def _gcs_upload(bucket_name: str, dataset: str, paths) -> None:
    """GCS leg of the backup: upload each weight file to
    `recsys-weights/<dataset>/<basename>`, never overwriting. Needs the
    optional google-cloud-storage package and the network; without them it
    raises and the backup falls through to NFS."""
    from google.cloud import storage  # noqa: PLC0415 — optional dependency

    bucket = storage.Client().bucket(bucket_name)
    for p in paths:
        if p and os.path.isfile(p):
            blob = bucket.blob(os.path.join("recsys-weights", dataset, os.path.basename(p)))
            blob.upload_from_filename(p, if_generation_match=0)


def backup_weights(paths, config=None, nfs_path=None, logger=None,
                   wandb_logger=None) -> list:
    """Weight backup: GCS (when `gcs_bucket_name` is set) → NFS
    (`nfs_backup_path`) → local `saved/<dataset>/` only if neither
    succeeded. `wandb_logger` (`utils/wandblogger.py`) logs each medium
    that succeeded and raises an alert when none did. → the media that
    succeeded."""
    config = config or {}
    warn = logger.warning if logger else print
    media: list = []
    paths = [p for p in paths if p and os.path.isfile(p)]

    if config.get("gcs_bucket_name"):
        try:
            _gcs_upload(config["gcs_bucket_name"], str(config.get("dataset", "")), paths)
            media.append("gcs")
        except Exception as e:  # noqa: BLE001 — any leg failure falls through
            warn(f"Failed to upload to GCS: {e}")

    if nfs_path is None:
        nfs_path = config.get("nfs_backup_path")
    if nfs_path:
        try:
            os.makedirs(nfs_path, exist_ok=True)
            for p in paths:
                shutil.copy2(p, nfs_path)
            media.append("nfs")
        except OSError as e:
            warn(f"Failed to write to NFS: {e}")

    if not media:
        try:
            backup_dir = os.path.join("saved", str(config.get("dataset", "")))
            os.makedirs(backup_dir, exist_ok=True)
            for p in paths:
                if os.path.abspath(os.path.dirname(p)) != os.path.abspath(backup_dir):
                    shutil.copy2(p, backup_dir)
            media.append("local")
        except OSError as e:
            warn(f"Failed to write to local: {e}")

    if wandb_logger is not None:
        for m in media:
            wandb_logger.log_raw({"file_backup_medium": m}, commit=False)
        if not media:
            wandb_logger.alert(title="Backup Failure", text="Failed to backup to any medium!")
    if not media:
        warn("Failed to backup to any medium!")
    return media


def _write_results(path: str, model: str, dataset: str, seed, test_result, inductive) -> None:
    payload = {
        "model": model,
        "dataset": dataset,
        "seed": seed,
        "test_result": {k: float(v) for k, v in (test_result or {}).items()},
        "inductive": {
            s: {k: float(v) for k, v in r.items()} for s, r in (inductive or {}).items()
        },
    }
    with open(path, "w") as f:
        json.dump(payload, f, indent=1)


def main(argv=None) -> Dict[str, Any]:
    from oovrec_tpu_torch.cli.inductive_eval import perform_inductive_eval
    from oovrec_tpu_torch.cli.quick_start import run

    args = parse_cli_args(argv if argv is not None else sys.argv[1:])
    if args.get("eval_only"):
        return eval_only(args)
    if "model" not in args or "dataset" not in args:
        raise SystemExit("usage: run.py --model=<M> --dataset=<D> [--k=v ...]")

    args = apply_paper_protocol(args)
    args = merge_dataset_config(args)

    res = run(model=args["model"], dataset=args["dataset"], config_dict=args, saved=True)
    trainer = res["trainer"]
    backup_weights([trainer.saved_model_file], config=res["config"],
                   nfs_path=res["config"]["nfs_backup_path"], logger=trainer.logger,
                   wandb_logger=trainer.wandblogger)

    if args.get("inductive_eval"):
        print("Performing inductive evaluation...")
        res["inductive_results"] = perform_inductive_eval(
            res["dataset"], trainer.saved_model_file, config=res["config"])

    if args.get("results_json"):
        _write_results(args["results_json"], args["model"], args["dataset"],
                       res["config"]["seed"], res.get("test_result"),
                       res.get("inductive_results"))
    return res


def eval_only(args: Dict[str, Any]) -> Dict[str, Any]:
    """`--eval_only=<checkpoint.pth>`: restore a saved run and repeat its
    test evaluation, and with `--inductive_eval` the 7-slice eval, without
    training. The other `--k=v` args override the checkpoint's config."""
    from oovrec_tpu_torch.cli.inductive_eval import perform_inductive_eval
    from oovrec_tpu_torch.cli.quick_start import load_data_and_model

    path = args.pop("eval_only")
    inductive = args.pop("inductive_eval", False)
    results_json = args.pop("results_json", None)
    for k in ("model", "dataset"):  # the checkpoint names them
        args.pop(k, None)
    loaded = load_data_and_model(path, config_overrides=args or None)
    trainer = loaded.trainer
    test_result = trainer.evaluate(loaded.test_loader, load_best_model=False)
    trainer.logger.info(f"test result: {test_result}")
    res: Dict[str, Any] = {
        "test_result": test_result,
        "config": loaded.config,
        "dataset": loaded.dataset,
        "trainer": trainer,
    }
    if inductive:
        print("Performing inductive evaluation...")
        res["inductive_results"] = perform_inductive_eval(loaded.dataset, path,
                                                          config=loaded.config)
    if results_json:
        _write_results(results_json, loaded.config["model"], loaded.config["dataset"],
                       loaded.config["seed"], test_result, res.get("inductive_results"))
    return res


if __name__ == "__main__":
    main()
