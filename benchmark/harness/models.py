"""The models the configurations name, on both sides.

A configuration's `model` names a module of `adapters/`, whose `Adapter`
builds the program's model from the configuration's sizes, makes the inputs
of a training mix, hands each batch to the reference and reads the
program's row gathers for the rooflines. The program's side is the port's
public entries (`oovrec_tpu_torch`); the reference's is `benchmark/reference`.
"""

from __future__ import annotations

import importlib
from typing import Dict

import torch


def spec_of(cfg: dict) -> dict:
    """The inductive layer's sizes that the reference reads."""
    c, ind = cfg["corpus"], cfg["port"]
    return {"n_old_users": c["n_old_users"], "n_old_items": c["n_old_items"],
            "n_new_users": c["n_new_users"], "n_new_items": c["n_new_items"],
            "n_user_buckets": ind["n_user_oov_buckets"], "n_item_buckets": ind["n_item_oov_buckets"],
            "prime_pad": ind["oov_prime_pad"]}


def inductive_spec(cfg: dict):
    from oovrec_tpu_torch.inductive.spec import InductiveSpec

    p = cfg["port"]
    return InductiveSpec(mapper=p["inductive_mapper"], add_oov_buckets=p["add_oov_buckets"],
                         n_user_buckets=p["n_user_oov_buckets"],
                         n_item_buckets=p["n_item_oov_buckets"],
                         hash_function=p["oov_hash_function"], prime_pad=p["oov_prime_pad"])


def adapter(cfg: dict):
    """The configuration's model adapter, `adapters/<model>.py`."""
    return importlib.import_module(f"benchmark.harness.adapters.{cfg['model']}").Adapter(cfg)


def weight_shapes(model: torch.nn.Module) -> Dict[str, tuple]:
    return {n: tuple(p.shape) for n, p in model.named_parameters()}
