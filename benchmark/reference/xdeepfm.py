"""xDeepFM, plain.

Lian et al., "xDeepFM: Combining Explicit and Implicit Feature Interactions
for Recommender Systems" (KDD 2018, arXiv:1803.05170), in the recommender's
form (RecBole `xDeepFM`, `xDeepFM.yaml`) with the random-mapper OOV buckets:

  * field embeddings (B, F, D): token fields from one table packed by field
    offsets (an id past its field's size clipped to the last row), float
    fields as value x the row of their bucket column (1 where the batch has
    none); token fields first, then float fields. The user and item cells
    route through the inductive layer: a new or flagged id takes its bucket
    row (`bpr.py` says how buckets are hashed; the reference hashes them);
  * CIN, not direct: layer i forms the pairwise Hadamard products of its
    input maps and the field embeddings, z[h*F + f] = x_h * x0_f, a 1x1 conv
    over the pair axis (kernel (H*F, L) and bias) and ReLU; every layer but
    the last gives its first half to the next layer and its second half to
    the output, the last all of it; the output maps are summed over D and a
    linear layer gives one logit;
  * the MLP over the flattened embeddings, dropout -> linear -> ReLU at every
    width of [F*D, 128, 128, 128, 1], the last included (RecBole's
    `MLPLayers` over `mlp_hidden_size + [1]`);
  * the first-order term: the same field structure at width 1, summed, plus
    a bias; its own OOV bucket tables;
  * the loss: binary cross entropy on the summed logits averaged over the
    weighted rows, plus reg_weight x the sum of the (unsquared) Frobenius
    norms of the CIN kernels, the MLP weights and the first-order tables.

Dropout draws keep-masks with `bernoulli_(1 - p)` from the generator the
caller passes, in the order of the MLP's layers; the program's trainer draws
its masks the same way from a generator seeded with seed + 101. The
reference follows that rule to draw the same masks, so the comparison is
tied to the program's order of draws: a program that draws its masks in
another order, soundly, reads as not correct until this rule follows it.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from benchmark.reference.hashes import eval_buckets, simulated_buckets

Params = Dict[str, torch.Tensor]


def _routed_cell(table, offset, n, bucket_table, ids, flags, n_orig, n_buckets, prime_pad):
    """The embedding of the user or item cell: the IV slice of the packed
    table, or the bucket row where the id is new or flagged."""
    host = ids.cpu().numpy()
    flag_host = flags.cpu().numpy()
    b = np.where(flag_host, simulated_buckets(host, n_orig, n_buckets, prime_pad),
                 np.where(host >= n_orig, eval_buckets(host, n_orig, n_buckets), 0))
    new = flags | (ids >= n)
    iv = table[offset + ids.clamp(0, n - 1)]
    return torch.where(new[:, None], bucket_table[torch.from_numpy(b).to(ids.device)], iv)


def field_embeddings(params: Params, prefix: str, batch: dict, schema: dict,
                     spec: dict) -> torch.Tensor:
    """(B, F, dim) of the table family under `prefix`."""
    tokens, dims = schema["token_fields"], schema["token_dims"]
    offsets = np.concatenate([[0], np.cumsum(dims)[:-1]])
    table = params[prefix + "token_embedding_table.weight"]
    cols = []
    for j, (name, dim) in enumerate(zip(tokens, dims)):
        ids = batch[name].long()
        if j < 2:  # the user and the item cell
            side = "user" if j == 0 else "item"
            f = batch.get(name + "_oov")
            flags = torch.zeros_like(ids, dtype=torch.bool) if f is None else f > 0
            cols.append(_routed_cell(
                table, int(offsets[j]), dim, params[f"{prefix}{side}_oov_buckets.weight"],
                ids, flags, spec[f"n_old_{side}s"], spec[f"n_{side}_buckets"],
                spec["prime_pad"]))
        else:
            cols.append(table[int(offsets[j]) + ids.clamp(max=dim - 1)])
    foffsets = np.concatenate([[0], np.cumsum(schema["float_dims"])[:-1]])
    for name, off in zip(schema["float_fields"], foffsets):
        ftable = params[prefix + "float_embedding_table.weight"]
        values = batch[name].float()
        bucket = batch.get(name + "__bucket")
        bucket = torch.ones_like(values, dtype=torch.long) if bucket is None else bucket.long()
        cols.append(values[:, None] * ftable[int(off) + bucket])
    return torch.stack(cols, dim=1)


def cin(params: Params, x0: torch.Tensor, sizes) -> torch.Tensor:
    """(B, F, D) -> (B, 1) through the CIN and its linear layer."""
    b, f, d = x0.shape
    hidden, pooled = x0, []
    for i, size in enumerate(sizes):
        z = (hidden[:, :, None, :] * x0[:, None, :, :]).reshape(b, -1, d)
        out = torch.relu(z.transpose(1, 2) @ params[f"conv1d_{i}.kernel"]
                         + params[f"conv1d_{i}.bias"]).transpose(1, 2)
        if i != len(sizes) - 1:
            hidden, part = out[:, : size // 2], out[:, size // 2:]
        else:
            part = out
        pooled.append(part.sum(dim=-1))
    p = torch.cat(pooled, dim=1)
    return p @ params["cin_linear.weight"].T + params["cin_linear.bias"]


def mlp(params: Params, x: torch.Tensor, n_layers: int, dropout: float,
        generator: Optional[torch.Generator]) -> torch.Tensor:
    keep = 1.0 - dropout
    for j in range(n_layers):
        if generator is not None and dropout > 0:
            mask = x.new_empty(x.shape).bernoulli_(keep, generator=generator)
            x = x * mask / keep
        x = torch.relu(x @ params[f"mlp_layers.Dense_{j}.weight"].T
                       + params[f"mlp_layers.Dense_{j}.bias"])
    return x


def logits(params: Params, batch: dict, schema: dict, spec: dict, model: dict,
           generator: Optional[torch.Generator]) -> torch.Tensor:
    emb = field_embeddings(params, "field_embedding.", batch, schema, spec)
    first = field_embeddings(params, "first_order_linear.fo.", batch, schema, spec)
    fo = first.sum(dim=(1, 2))[:, None] + params["first_order_linear.bias"]
    c = cin(params, emb, model["cin_layer_size"])
    n_layers = len(model["mlp_hidden_size"]) + 1
    d = mlp(params, emb.reshape(emb.shape[0], -1), n_layers, model["dropout_prob"], generator)
    return (fo + c + d).squeeze(-1)


def reg(params: Params, model: dict) -> torch.Tensor:
    names = [f"conv1d_{i}.kernel" for i in range(len(model["cin_layer_size"]))]
    names += [f"mlp_layers.Dense_{j}.weight" for j in range(len(model["mlp_hidden_size"]) + 1)]
    names += sorted(n for n in params
                    if n.startswith("first_order_linear.fo.") and params[n].dim() >= 2)
    return sum(torch.linalg.vector_norm(params[n]) for n in names)


def loss(params: Params, batch: dict, spec: dict, schema: dict, model: dict,
         generator: Optional[torch.Generator] = None, dtype=torch.float32) -> torch.Tensor:
    """BCE on the logits over the weighted rows + reg_weight x reg. `dtype`
    is float32 here; a control lowers the precision of the products by
    TF32 (`torch.backends.cuda.matmul.allow_tf32`), which the caller sets."""
    y = logits(params, batch, schema, spec, model, generator)
    t = batch["label"].float()
    terms = torch.clamp(y, min=0) - y * t + torch.log1p(torch.exp(-torch.abs(y)))
    w = batch["weight"].float()
    bce = (terms * w).sum() / torch.clamp(w.sum(), min=1.0)
    return bce + model["reg_weight"] * reg(params, model)
