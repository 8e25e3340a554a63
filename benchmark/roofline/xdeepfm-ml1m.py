"""xDeepFM at its published widths over MovieLens 1M's seven fields
(`configs/xdeepfm-ml1m.json`): the operations and bytes of a step and of its
CIN stack."""

from __future__ import annotations

from benchmark.roofline import kernels


def _layers(cfg: dict, mix: dict):
    s, a = cfg["corpus"]["schema"], cfg["model_args"]
    n_fields = len(s["token_fields"]) + len(s["float_fields"])
    return kernels.cin_layers(mix["port"]["train_batch_size"], n_fields, a["embedding_size"],
                              a["cin_layer_size"], a["direct"]), n_fields


def cin_step(cfg: dict, mix: dict):
    """Kernels 4 and 5 of one training step: the stack forward and backward."""
    layers, _ = _layers(cfg, mix)
    f1, b1 = kernels.cin_forward(layers)
    f2, b2 = kernels.cin_backward(layers)
    return f1 + f2, b1 + b2


def n_params(cfg: dict) -> int:
    s, a, p = cfg["corpus"]["schema"], cfg["model_args"], cfg["port"]
    d = a["embedding_size"]
    n_fields = len(s["token_fields"]) + len(s["float_fields"])
    tables = sum(s["token_dims"]) + sum(s["float_dims"]) + p["n_user_oov_buckets"] \
        + p["n_item_oov_buckets"]
    layers = kernels.cin_layers(1, n_fields, d, a["cin_layer_size"], a["direct"])
    cin = sum(h * f * l + l for _, h, f, _, l, _, _ in layers)
    pooled = sum(lp for *_, lp in layers)
    widths = [n_fields * d] + list(a["mlp_hidden_size"]) + [1]
    mlp = sum(i * o + o for i, o in zip(widths[:-1], widths[1:]))
    return tables * (d + 1) + cin + pooled + 1 + mlp + 1


def train_step(cfg: dict, mix: dict):
    """One step of B labelled rows: the CIN forward and backward, the MLP and
    the CIN's linear layer forward and backward (three products a layer);
    dense Adam over every parameter and the rows' field embeddings read."""
    layers, n_fields = _layers(cfg, mix)
    a = cfg["model_args"]
    B, d = mix["port"]["train_batch_size"], a["embedding_size"]
    cf, _ = cin_step(cfg, mix)
    widths = [n_fields * d] + list(a["mlp_hidden_size"]) + [1]
    mlp = 3 * 2 * B * sum(i * o for i, o in zip(widths[:-1], widths[1:]))
    linear = 3 * 2 * B * sum(lp for *_, lp in layers)
    flops = cf + mlp + linear
    nbytes = kernels.adam_dense(n_params(cfg)) + B * n_fields * (8 + 4 * (d + 1))
    return flops, nbytes


def gather_bwd_step(cfg: dict, gathers) -> int:
    return sum(kernels.gather_backward(*g) for g in gathers)
