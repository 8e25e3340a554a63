"""DirectAU — alignment + uniformity on L2-normalised two-tower embeddings.

Port of `oovrec_tpu/models/directau.py:28-125` (the reference's
`directau.py:18-220`):

    loss = mean‖u−i‖² + γ·(U(u) + U(i))/2,   U(x) = log mean_{i<j} exp(−2‖xᵢ−xⱼ‖²)

over the batch's pointwise-expanded rows (labels are ignored, as in the
reference), on L2-normalised embeddings. The alignment is the weighted
mean over the rows; the uniformity's pair mean weighs each pair i < j by
the product of its rows' weights, so padded rows add nothing. Under the
mesh both run over the global batch: the alignment's sums over every data
rank's rows, the uniformity over every pair of the gathered rows.

`predict` is the cosine of the routed embeddings. `full_sort_scores`,
`score_against` and the towers of the fused top-k kernel use the
UNNORMALISED embeddings, as `ind_full_sort_predict` does
(`directau.py:113-125`). `sparse_table_fields` declares the ID tables as
pure row lookups, so under `learner: sparse_adam` the trainer takes the
row-sparse step (kernel 6) for them.
"""

from __future__ import annotations

import torch

from oovrec_tpu_torch.models.base import Batch, IDTowerRecommender, register_model
from oovrec_tpu_torch.parallel.train_step import batch_mean, batch_wmean, global_rows
from oovrec_tpu_torch.utils.enums import InputType


def _l2norm(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=eps)


def alignment(u: torch.Tensor, i: torch.Tensor, w=None) -> torch.Tensor:
    """‖u−i‖² (alpha = 2), the weighted mean over the rows."""
    d = ((u - i) ** 2).sum(dim=1)
    if w is None:
        return batch_mean(d)
    return batch_wmean(d, w)


def uniformity(x: torch.Tensor, w=None, t: float = 2.0) -> torch.Tensor:
    """log mean_{i<j} exp(−t‖xᵢ−xⱼ‖²), each pair weighted by w_i·w_j
    (`torch.pdist` semantics with pad-pair masking), over every pair of the
    global batch's rows (`global_rows`)."""
    x, _ = global_rows(x)
    w = None if w is None else global_rows(w)[0]
    sq = (x * x).sum(dim=1)
    d2 = sq[:, None] + sq[None, :] - 2.0 * (x @ x.T)
    # jnp.maximum's gradient at a tie: half to each side
    d2 = torch.maximum(d2, torch.zeros_like(d2))
    n = x.shape[0]
    iu = torch.triu(torch.ones((n, n), dtype=torch.bool, device=x.device), diagonal=1)
    pair_w = iu.to(x.dtype) if w is None else (w[:, None] * w[None, :]) * iu
    e = torch.exp(-t * d2) * pair_w
    return torch.log(e.sum() / torch.clamp(pair_w.sum(), min=1.0))


@register_model
class DirectAU(IDTowerRecommender):
    input_type = InputType.POINTWISE

    def __init__(self, *args, gamma: float = 1.0, **kwargs):
        super().__init__(*args, **kwargs)
        self.gamma = float(gamma)

    def sparse_table_fields(self):
        """Sparse fast-path declaration (train/sparse_update.py):
        calculate_loss reads only (uid, iid) rows of the ID tables."""
        return {
            "user": ("user_embedding", [self.uid_field]),
            "item": ("item_embedding", [self.iid_field]),
        }

    def calculate_loss(self, batch: Batch) -> torch.Tensor:
        w = batch.get("weight")
        w = None if w is None else w.float()
        u = _l2norm(self.user_e(batch[self.uid_field], batch))
        i = _l2norm(self.item_e(batch[self.iid_field], batch))
        uniform = self.gamma * (uniformity(u, w) + uniformity(i, w)) / 2.0
        return alignment(u, i, w) + uniform

    def predict(self, batch: Batch) -> torch.Tensor:
        u = _l2norm(self.user_e(batch[self.uid_field], batch))
        i = _l2norm(self.item_e(batch[self.iid_field], batch))
        return (u * i).sum(dim=1)
