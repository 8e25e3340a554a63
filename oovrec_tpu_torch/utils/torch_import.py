"""Seed a model from a reference (RecBole, PyTorch) checkpoint.

Port of `oovrec_tpu/utils/torch_import.py` for the models the port has:
a reference `.pth` state_dict, laid out module by module as RecBole saves
it, becomes the flax param tree of the JAX package, which the weight
bridge (`utils/jax_params.py:load_flax_params`) then loads. The layout
rules (`torch_import.py:10-14` there):

  * ``nn.Embedding.weight`` → ``{"embedding": W}``;
  * ``nn.Linear.weight`` / ``bias`` → ``{"kernel": Wᵀ, "bias": b}``;
  * xDeepFM's ``conv1d_list.<i>`` (Conv1d, kernel size 1, (L, H·F, 1)) →
    ``conv1d_<i>`` ``{"kernel": W[:, :, 0]ᵀ, "bias": b}``;
  * DCNv2's per-layer lists (``cross_layer_w.<i>``, ``cross_layer_u/v/c``,
    ``bias.<i>``) stacked into one leaf each, its ``gating.<e>`` Linears
    as ``gating_<e>``;
  * an MLP's ``mlp_layers.mlp_layers.<i>`` Linears as ``Dense_0``, ``Dense_1``,
    ... in order, and (DCNv2) its BatchNorm1d modules as ``BatchNorm_<j>``:
    ``weight`` / ``bias`` as ``scale`` / ``bias``, the running mean and
    variance as the ``batch_stats`` that `import_batch_stats` gives. The
    JAX map counts a BatchNorm's ``weight`` as one more Linear
    (`_mlp_direct` there), so its DCNv2 import puts that vector where
    ``Dense_1``'s kernel belongs; the port does not follow it there;
  * GRU4Rec's ``gru_layers`` (a `torch.nn.GRU`, gates r, z, n packed) as
    ``gru_<i>`` flax `GRUCell`s (`_gru_cell`), every layer: the JAX map
    (`torch_import.py:107-112` there) maps layer 0 alone, so at
    `num_layers` 2 its import leaves ``gru_1`` as drawn.

`import_state_dict` maps BPR, DirectAU, LightGCN (its two tables,
`torch_import.py:102-106` there), GRU4Rec, WideDeep, DCNv2 and xDeepFM; any
other model raises NotImplementedError with the JAX map's text. Only the
keys the map names are returned: `merge_params` gives every other leaf of
the model its current value, as the JAX `run`'s `_merge` does
(`cli/quick_start.py:207-233` there). The file is read with
`torch.load(weights_only=True)`, which builds tensors and containers and
runs nothing else of the pickle.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

SUPPORTED = "BPR, DirectAU, LightGCN, GRU4Rec, WideDeep, DCNV2, xDeepFM"


def _emb(sd, key):
    return {"embedding": np.asarray(sd[key])}


def _lin(sd, key):
    out = {"kernel": np.asarray(sd[f"{key}.weight"]).T}
    if f"{key}.bias" in sd:
        out["bias"] = np.asarray(sd[f"{key}.bias"])
    return out


def _gru_cell(sd, prefix: str, layer: int) -> Dict[str, Any]:
    """Layer `layer` of a `torch.nn.GRU` (gates r, z, n packed by rows) as
    flax's `GRUCell`: the r and z parts of `bias_hh` fold into `ir` / `iz`,
    the n parts stay apart (`in`, `hn`); without biases (`bias=False`, as
    RecBole's GRU4Rec builds it) they are 0."""
    w_ih = sd[f"{prefix}.weight_ih_l{layer}"]
    w_hh = sd[f"{prefix}.weight_hh_l{layer}"]
    r_i, z_i, n_i = np.split(w_ih, 3, 0)
    r_h, z_h, n_h = np.split(w_hh, 3, 0)
    if f"{prefix}.bias_ih_l{layer}" in sd:
        br_i, bz_i, bn_i = np.split(sd[f"{prefix}.bias_ih_l{layer}"], 3)
        br_h, bz_h, bn_h = np.split(sd[f"{prefix}.bias_hh_l{layer}"], 3)
    else:
        br_i = bz_i = bn_i = br_h = bz_h = bn_h = np.zeros(w_hh.shape[1], np.float32)
    return {"ir": {"kernel": r_i.T, "bias": br_i + br_h},
            "iz": {"kernel": z_i.T, "bias": bz_i + bz_h},
            "in": {"kernel": n_i.T, "bias": bn_i},
            "hr": {"kernel": r_h.T}, "hz": {"kernel": z_h.T},
            "hn": {"kernel": n_h.T, "bias": bn_h}}


def _context_tables(sd, with_fo=True) -> Dict[str, Any]:
    p: Dict[str, Any] = {"fields": {
        "token_embedding_table": _emb(sd, "token_embedding_table.embedding.weight"),
    }}
    if "float_embedding_table.embedding.weight" in sd:
        p["fields"]["float_embedding_table"] = _emb(sd, "float_embedding_table.embedding.weight")
    for side in ("user", "item"):
        k = f"{side}_oov_buckets.weight"
        if k in sd:
            p["fields"][f"{side}_oov_buckets"] = _emb(sd, k)
    if with_fo and "first_order_linear.bias" in sd:
        fo: Dict[str, Any] = {"token_embedding_table": _emb(
            sd, "first_order_linear.token_embedding_table.embedding.weight")}
        if "first_order_linear.float_embedding_table.embedding.weight" in sd:
            fo["float_embedding_table"] = _emb(
                sd, "first_order_linear.float_embedding_table.embedding.weight")
        for side in ("user", "item"):
            k = f"first_order_linear.{side}_oov_buckets.weight"
            if k in sd:
                fo[f"{side}_oov_buckets"] = _emb(sd, k)
        p["first_order_linear"] = {"bias": np.asarray(sd["first_order_linear.bias"]), "fo": fo}
    return p


def _mlp_modules(sd, prefix):
    """The module indices of a RecBole `MLPLayers` (`<prefix>.mlp_layers.<i>`:
    dropout, Linear, BatchNorm1d where `bn`, activation) that hold weights:
    (Linears, BatchNorms) in order, a BatchNorm told by its running mean."""
    idx = sorted(int(k.split(".")[-2]) for k in sd
                 if k.startswith(f"{prefix}.mlp_layers.") and k.endswith(".weight"))
    bn = [i for i in idx if f"{prefix}.mlp_layers.{i}.running_mean" in sd]
    return [i for i in idx if i not in bn], bn


def _mlp(sd, prefix) -> Dict[str, Any]:
    """An `MLPLayers`' Linears as flax's `Dense_<j>` and its BatchNorms'
    affine parameters as `BatchNorm_<j>` (`scale`, `bias`)."""
    dense, bn = _mlp_modules(sd, prefix)
    out = {f"Dense_{j}": _lin(sd, f"{prefix}.mlp_layers.{i}") for j, i in enumerate(dense)}
    for j, i in enumerate(bn):
        out[f"BatchNorm_{j}"] = {"scale": np.asarray(sd[f"{prefix}.mlp_layers.{i}.weight"]),
                                 "bias": np.asarray(sd[f"{prefix}.mlp_layers.{i}.bias"])}
    return out


def import_batch_stats(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """The running statistics of the BatchNorms of a reference `mlp_layers`
    (DCNv2's) as flax's ``batch_stats`` tree; {} where it has none."""
    sd = {k: np.asarray(v) for k, v in sd.items()}
    _, bn = _mlp_modules(sd, "mlp_layers")
    if not bn:
        return {}
    return {"mlp_layers": {f"BatchNorm_{j}": {
        "mean": sd[f"mlp_layers.mlp_layers.{i}.running_mean"],
        "var": sd[f"mlp_layers.mlp_layers.{i}.running_var"]} for j, i in enumerate(bn)}}


def _count(sd, prefix, suffix="") -> int:
    n = 0
    while f"{prefix}{n}{suffix}" in sd:
        n += 1
    return n


def import_state_dict(model_name: str, sd: Mapping[str, Any]) -> Dict[str, Any]:
    """A reference state_dict (numpy-able values) → the flax param tree of
    the JAX package's model of that name (the keys it names)."""
    sd = {k: np.asarray(v) for k, v in sd.items()}
    name = model_name.lower()
    if name in ("bpr", "directau"):
        p = {"user_embedding": _emb(sd, "user_embedding.weight"),
             "item_embedding": _emb(sd, "item_embedding.weight")}
        for side in ("user", "item"):
            k = f"{side}_oov_buckets.weight"
            if k in sd:
                p[f"{side}_oov_buckets"] = _emb(sd, k)
        return p
    if name == "lightgcn":
        return {"user_embedding": _emb(sd, "user_embedding.weight"),
                "item_embedding": _emb(sd, "item_embedding.weight")}
    if name == "gru4rec":
        p = {"item_embedding": _emb(sd, "item_embedding.weight"),
             "dense": _lin(sd, "dense")}
        for i in range(_count(sd, "gru_layers.weight_ih_l")):
            p[f"gru_{i}"] = _gru_cell(sd, "gru_layers", i)
        return p
    if name == "widedeep":
        p = _context_tables(sd)
        p["mlp_layers"] = _mlp(sd, "mlp_layers")
        p["deep_predict_layer"] = _lin(sd, "deep_predict_layer")
        return p
    if name == "dcnv2":
        p = _context_tables(sd, with_fo=False)
        if "cross_layer_w.0" in sd:
            n = _count(sd, "cross_layer_w.")
            p["cross_layer_w"] = np.stack([sd[f"cross_layer_w.{i}"] for i in range(n)])
        else:
            n = _count(sd, "cross_layer_u.")
            for part in ("u", "v", "c"):
                p[f"cross_layer_{part}"] = np.stack(
                    [sd[f"cross_layer_{part}.{i}"] for i in range(n)])
            for e in range(_count(sd, "gating.", ".weight")):
                p[f"gating_{e}"] = _lin(sd, f"gating.{e}")
        p["cross_bias"] = np.stack([sd[f"bias.{i}"].reshape(-1) for i in range(n)])
        p["mlp_layers"] = _mlp(sd, "mlp_layers")
        p["predict_layer"] = _lin(sd, "predict_layer")
        return p
    if name == "xdeepfm":
        p = _context_tables(sd)
        for i in range(_count(sd, "conv1d_list.", ".weight")):
            w = sd[f"conv1d_list.{i}.weight"]  # (out, in, 1)
            p[f"conv1d_{i}"] = {"kernel": w[:, :, 0].T, "bias": sd[f"conv1d_list.{i}.bias"]}
        p["cin_linear"] = _lin(sd, "cin_linear")
        p["mlp_layers"] = _mlp(sd, "mlp_layers")
        return p
    raise NotImplementedError(
        f"No torch-import map for model [{model_name}] yet; supported: {SUPPORTED}")


def merge_params(current: Mapping[str, Any], imported: Mapping[str, Any]) -> Dict[str, Any]:
    """`current` (a flax tree) with every leaf that `imported` names taken
    from it; the others keep their values."""
    out = {}
    for k, v in current.items():
        if k not in imported:
            out[k] = v
        elif isinstance(v, Mapping) and isinstance(imported[k], Mapping):
            out[k] = merge_params(v, imported[k])
        else:
            out[k] = imported[k]
    return out


def import_reference_checkpoint(model_name: str, path: str) -> Tuple[Dict[str, Any],
                                                                     Dict[str, Any]]:
    """Read a reference `.pth` (its `state_dict` entry, or the whole file
    when it is one). → (the param tree, `import_state_dict`; the BatchNorm
    statistics, `import_batch_stats`)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt["state_dict"] if "state_dict" in ckpt else ckpt
    sd = {k: v.numpy() for k, v in sd.items()}
    return import_state_dict(model_name, sd), import_batch_stats(sd)
