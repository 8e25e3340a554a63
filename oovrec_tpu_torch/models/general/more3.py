"""FISM, NAIS, ENMF, LINE, ConvNCF and SLIMElastic.

Port of `oovrec_tpu/models/general/more3.py:23-359`.
  * FISM (pointwise rows): the user is the sum of the source embeddings
    of their history (`base.py:padded_history`, at most 200 items, the
    target excluded) over cnt^α; its dot with the target's destination
    embedding plus the user's and the item's biases; BCE on logits.
    `reg_weights` is read and unused, as in the JAX model.
  * NAIS: FISM with attention: each history item weighs
    exp(att_h · relu(att_w(src ⊙ dst))), the weights over (Σ)^β.
  * ENMF (user batches): the whole-corpus non-sampling loss, the
    positive part over the user's history and the negative part through
    the (D, D) Gram matrices of the item table and of `h`; the user's row
    takes dropout always in the loss (the JAX model's
    `deterministic=False`), its keep mask from the trainer's dropout
    generator.
  * LINE (pairwise): `user_embedding` against `item_embedding` and, under
    `order: 2`, against `item_ctx`; the negative-sampling losses of both
    summed. There is no `user_ctx`: flax creates a setup module only when
    it is called, and the JAX model never calls it.
  * ConvNCF (pairwise): the outer product of the user's and the item's
    rows, a (D, D, 1) image, through `conv_<i>`, each flax's `nn.Conv`
    with a 2×2 kernel at stride 2 (SAME padding: none at an even size,
    one zero row and column at the end of an odd one), relu; flattened in
    flax's (H, W, C) order before `out`; BPR. A conv is a product of the
    non-overlapping 2×2 patches with the kernel (`sequential/convs.py:
    Conv`, flax's layout, no cuDNN call: cuDNN's weight gradient need not
    be deterministic, and a captured step must equal the eager one bit
    for bit). `reg_weight` is read and unused.
NAIS's and ConvNCF's full sorts score the batch's users against blocks of
items (`models/base.py:score_item_blocks`, at most `FULL_SORT_ELEMS` elements
of a block's largest intermediate), where the JAX models vmap over all the
items at once: at 256 users and 3,707 items that is 48.6 GB of NAIS's
(N, B, H, D) product and 124 GB of ConvNCF's first conv output (ROADMAP
§3). Each block computes the per-pair definition.

SLIMElastic is a traditional model (`models/general/base.py`); scoring is
`user_hist_matrix[users] @ slim_W` on the model's device.

The JAX package fits `sklearn.linear_model.ElasticNet(alpha, l1_ratio,
positive=True, fit_intercept=False, max_iter=100, tol=1e-4)` once per
item j ≥ 1 on the matrix X with column j zeroed (y = X[:, j]); column 0
stays zero. sklearn is not a dependency of the port, and a loop of such
fits is hours at MovieLens-1M's shape, so `slim_elastic_solve` runs the
same cyclic coordinate descent for every column at once, on the Gram
matrix G = XᵀX (integer counts, exact in float32):
  * problem j's feature k sees ρ = G[k, j] − G[k, :]·W[:, j] + G[k, k]·W[k, j]
    (X_kᵀ of the residual with feature k's own part added back; W[j, j]
    is 0, so X with column j zeroed and X give the same product);
  * a sweep visits k = 0 … n − 1 in order and sets row k of W for every
    column at once: max(ρ − α·l1·N, 0) / (G[k, k] + α·(1 − l1)·N), with
    N = n_users, the positive branch of sklearn's update; feature k is
    absent from problem k, so W[k, k] stays 0, and a feature with
    G[k, k] = 0 is skipped, as sklearn skips it;
  * sklearn's stopping rule, per column, checked after each sweep (and
    once before the first): where the largest change of the sweep is at
    most `tol` times the largest coefficient (or every coefficient is 0,
    or the sweep is the last), the duality gap of its formulation A
    (`_cd_fast.pyx:gap_enet`, positive: the dual norm is the largest
    entry of X_{-j}ᵀR − βw) is computed, and a column whose gap is at
    most `tol`·‖y‖² stops moving: a mask, no host branch per item.
sklearn 1.9 also screens features out by the gap (gap-safe rules) before
and between sweeps; the port does not, so its iterates differ from
sklearn's while both converge to the same optimum: each stopped column's
objective lies within its duality tolerance `tol`·‖y‖² of the optimum.
On the card a sweep is captured once as a CUDA graph and replayed.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from oovrec_tpu_torch.models.base import (
    Batch,
    GeneralRecommender,
    register_model,
    score_item_blocks,
)
from oovrec_tpu_torch.models.context import dense, raw_param
from oovrec_tpu_torch.models.general.base import (
    HistoryProductRecommender,
    PaddedHistoryModel,
    config_values,
    history_matrix,
    normal_table,
)
from oovrec_tpu_torch.models.layers import RandomDraws
from oovrec_tpu_torch.models.losses import _wmean, bce_with_logits, bpr_loss
from oovrec_tpu_torch.models.sequential.convs import Conv
from oovrec_tpu_torch.ops.embed_grad import gather_rows
from oovrec_tpu_torch.utils.device import resolve_device
from oovrec_tpu_torch.utils.enums import InputType


def gather_bias(bias: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """`bias[ids]` of an (n,) bias through `gather_rows`."""
    return gather_rows(bias[:, None], ids)[..., 0]


@register_model
class FISM(PaddedHistoryModel):
    input_type = InputType.POINTWISE

    def __init__(self, n_users: int, n_items: int, embedding_size: int = 64,
                 alpha: float = 0.0, reg_weights: Sequence[float] = (2e-2, 2e-2),
                 label_field: str = "label", **kwargs):
        super().__init__(n_users, n_items, embedding_size, **kwargs)
        self.label_field = label_field
        self.alpha = float(alpha)
        self.reg_weights = tuple(float(r) for r in reg_weights)
        self.item_src = normal_table(self, n_items, embedding_size)
        self.item_dst = normal_table(self, n_items, embedding_size)
        self.user_bias = torch.nn.Parameter(torch.zeros(n_users, device=self.device))
        self.item_bias = torch.nn.Parameter(torch.zeros(n_items, device=self.device))

    def _biases(self, users: torch.Tensor, items: torch.Tensor) -> torch.Tensor:
        return gather_bias(self.user_bias, users) + gather_bias(self.item_bias, items)

    def _score(self, users: torch.Tensor, items: torch.Tensor) -> torch.Tensor:
        hist, inside = self.padded(users)
        mask = inside & (hist != items.long()[:, None])  # the target left out
        cnt = torch.clamp(mask.sum(dim=1).float(), min=1.0)
        src = gather_rows(self.item_src.weight, hist) * mask[:, :, None]
        user_repr = src.sum(dim=1) / cnt[:, None] ** self.alpha
        dst = gather_rows(self.item_dst.weight, items)
        return (user_repr * dst).sum(dim=1) + self._biases(users, items)

    def calculate_loss(self, batch: Batch) -> torch.Tensor:
        out = self._score(batch[self.uid_field], batch[self.iid_field])
        return bce_with_logits(out, batch[self.label_field], batch.get("weight"))

    def predict(self, batch: Batch) -> torch.Tensor:
        return torch.sigmoid(self._score(batch[self.uid_field], batch[self.iid_field]))

    def full_sort_scores(self, batch: Batch) -> torch.Tensor:
        users = batch[self.uid_field]
        hist, inside = self.padded(users)
        cnt = torch.clamp(inside.sum(dim=1).float(), min=1.0)
        src = self.item_src.weight[hist] * inside[:, :, None]
        user_repr = src.sum(dim=1) / cnt[:, None] ** self.alpha
        return (user_repr @ self.item_dst.weight.T + self.user_bias[users.long()][:, None]
                + self.item_bias[None, :])


@register_model
class NAIS(FISM):
    def __init__(self, n_users: int, n_items: int, embedding_size: int = 64,
                 weight_size: int = 64, beta: float = 0.5, **kwargs):
        super().__init__(n_users, n_items, embedding_size, **kwargs)
        self.weight_size, self.beta = int(weight_size), float(beta)
        self.att_w = dense(self, embedding_size, self.weight_size)
        self.att_h = raw_param(self, self.weight_size, 1)

    def _pairs(self, src: torch.Tensor, hist: torch.Tensor, inside: torch.Tensor,
               items: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
        """(B, T) of Σ attention · src · dst: `src` (B, H, D) the users'
        history rows, `items` (B, T) or (T,) with their rows `dst`
        (B, T, D) or (T, D)."""
        mask = inside[:, None, :] & (hist[:, None, :] != items.long()[..., None])
        dst = dst.expand(src.shape[0], *dst.shape[-2:])
        prod = src[:, None] * dst[:, :, None, :]                   # (B, T, H, D)
        logits = (torch.relu(self.att_w(prod)) @ self.att_h).squeeze(-1)
        e = torch.where(mask, torch.exp(logits), torch.zeros_like(logits))
        denom = torch.clamp(e.sum(dim=-1), min=1e-12) ** self.beta
        att = e / denom[..., None]
        user_repr = torch.einsum("bth,bhd->btd", att, src)
        return (user_repr * dst).sum(dim=-1)

    def _score(self, users: torch.Tensor, items: torch.Tensor) -> torch.Tensor:
        hist, inside = self.padded(users)
        src = gather_rows(self.item_src.weight, hist)
        dst = gather_rows(self.item_dst.weight, items)
        out = self._pairs(src, hist, inside, items[:, None], dst[:, None])[:, 0]
        return out + self._biases(users, items)

    def full_sort_scores(self, batch: Batch) -> torch.Tensor:
        """(B, n_items) over blocks of items: a block holds at most
        `FULL_SORT_ELEMS` elements of the (B, T, H, D) product."""
        users = batch[self.uid_field]
        hist, inside = self.padded(users)
        src = self.item_src.weight[hist]
        ub = self.user_bias[users.long()][:, None]

        def block(items):
            return (self._pairs(src, hist, inside, items, self.item_dst.weight[items][None])
                    + ub + self.item_bias[items][None, :])

        B, H = hist.shape
        per_item = B * H * max(self.embedding_size, self.weight_size)
        return score_item_blocks(self.n_items, per_item, users.device, block)


@register_model
class ENMF(PaddedHistoryModel):
    input_type = InputType.POINTWISE
    train_on_users = True

    def __init__(self, n_users: int, n_items: int, embedding_size: int = 64,
                 dropout_prob: float = 0.7, negative_weight: float = 0.5, **kwargs):
        super().__init__(n_users, n_items, embedding_size, **kwargs)
        self.dropout_prob = float(dropout_prob)
        self.negative_weight = float(negative_weight)
        self.user_embedding = normal_table(self, n_users, embedding_size)
        self.item_embedding = normal_table(self, n_items, embedding_size)
        self.h = torch.nn.Parameter(torch.full((embedding_size, 1), 0.01, device=self.device))
        self.draws = RandomDraws()

    def calculate_loss(self, batch: Batch) -> torch.Tensor:
        users = batch[self.uid_field]
        # the JAX model's dropout is on in the loss whatever the mode
        u = self.draws.dropout(gather_rows(self.user_embedding.weight, users),
                               self.dropout_prob)
        hist, inside = self.padded(users)
        ie = gather_rows(self.item_embedding.weight, hist)               # (B, H, D)
        pos_score = ((u[:, None, :] * ie) @ self.h).squeeze(-1)         # (B, H)
        nw = self.negative_weight
        pos_part = (inside.float() * ((1 - nw) * pos_score ** 2 - 2 * pos_score)).sum(dim=1)
        items = self.item_embedding.weight
        weighted = (items.T @ items) * (self.h @ self.h.T)               # (D, D)
        neg_part = nw * ((u @ weighted) * u).sum(dim=1)
        return _wmean(pos_part + neg_part, batch.get("weight"))

    def predict(self, batch: Batch) -> torch.Tensor:
        u = self.user_embedding.weight[batch[self.uid_field].long()]
        i = self.item_embedding.weight[batch[self.iid_field].long()]
        return ((u * i) @ self.h).squeeze(-1)

    def full_sort_scores(self, batch: Batch) -> torch.Tensor:
        u = self.user_embedding.weight[batch[self.uid_field].long()]
        return (u * self.h[:, 0]) @ self.item_embedding.weight.T


@register_model
class LINE(GeneralRecommender):
    input_type = InputType.PAIRWISE

    def __init__(self, n_users: int, n_items: int, embedding_size: int = 64, order: int = 2,
                 **kwargs):
        super().__init__(n_users, n_items, embedding_size, **kwargs)
        self.order = int(order)
        self.user_embedding = normal_table(self, n_users, embedding_size)
        self.item_embedding = normal_table(self, n_items, embedding_size)
        if self.order == 2:
            self.item_ctx = normal_table(self, n_items, embedding_size)

    def calculate_loss(self, batch: Batch) -> torch.Tensor:
        u = gather_rows(self.user_embedding.weight, batch[self.uid_field])
        pos, neg = batch[self.iid_field], batch[self.neg_prefix + self.iid_field]
        w = batch.get("weight")

        def ns_loss(table):
            p, n = gather_rows(table, pos), gather_rows(table, neg)
            loss = -F.logsigmoid((u * p).sum(dim=1)) - F.logsigmoid(-(u * n).sum(dim=1))
            return _wmean(loss, w)

        total = ns_loss(self.item_embedding.weight)
        if self.order == 2:
            total = total + ns_loss(self.item_ctx.weight)
        return total

    def predict(self, batch: Batch) -> torch.Tensor:
        u = self.user_embedding.weight[batch[self.uid_field].long()]
        return (u * self.item_embedding.weight[batch[self.iid_field].long()]).sum(dim=1)

    def full_sort_scores(self, batch: Batch) -> torch.Tensor:
        u = self.user_embedding.weight[batch[self.uid_field].long()]
        return u @ self.item_embedding.weight.T


def conv_patches(x: torch.Tensor, conv: Conv) -> torch.Tensor:
    """`conv`'s product with patches (…, 4·C) laid out in its kernel's
    (kh, kw, in) order, plus its bias: (…, C_out)."""
    c_in = conv.kernel.shape[2]
    return F.linear(x, conv.kernel.reshape(4 * c_in, -1).T, conv.bias)


def patch_conv(x: torch.Tensor, conv: Conv) -> torch.Tensor:
    """flax's `nn.Conv(c, (2, 2), strides=(2, 2))` (SAME padding) on
    (N, H, W, C): an odd side gets one zero row or column at its end, then
    each 2×2 patch, in the kernel's (kh, kw, in) order, times the kernel."""
    n, h, w, c = x.shape
    if h % 2 or w % 2:
        x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
    h, w = x.shape[1] // 2, x.shape[2] // 2
    return conv_patches(x.reshape(n, h, 2, w, 2, c).permute(0, 1, 3, 2, 4, 5)
                        .reshape(n, h, w, 4 * c), conv)


def nested_outer(u: torch.Tensor, i: torch.Tensor, levels: int) -> torch.Tensor:
    """The (n, D, D) outer products of the rows of u and i, D = m·2^L, in
    nested patch order (n, m, m, 4^L): image row r = p·2^L + Σ a_l·2^(l−1)
    and column s likewise, the element order (p, q, a_L, b_L, …, a_1,
    b_1). Each conv l then reads its 2×2 patches (a_l, b_l, channels) as
    the innermost axes, with no copy: the same products as the image's,
    only placed otherwise."""
    n, d = u.shape
    m = d >> levels
    uu = u.reshape((n, m, 1) + (2, 1) * levels)
    ii = i.reshape((n, 1, m) + (1, 2) * levels)
    return (uu * ii).reshape(n, m, m, 4 ** levels)


@register_model
class ConvNCF(GeneralRecommender):
    input_type = InputType.PAIRWISE

    def __init__(self, n_users: int, n_items: int, embedding_size: int = 64,
                 cnn_channels: Sequence[int] = (32, 32), reg_weight: float = 0.0, **kwargs):
        super().__init__(n_users, n_items, embedding_size, **kwargs)
        self.cnn_channels = tuple(int(c) for c in cnn_channels)
        self.reg_weight = float(reg_weight)
        self.user_embedding = self._embed_table(n_users)
        self.item_embedding = self._embed_table(n_items)
        self.convs = []
        side, c_in = embedding_size, 1
        for i, c in enumerate(self.cnn_channels):
            self.add_module(f"conv_{i}", Conv((2, 2, c_in, c), self.device, self.generator))
            self.convs.append(getattr(self, f"conv_{i}"))
            side, c_in = (side + 1) // 2, c
        self.out = dense(self, side * side * c_in, 1)
        # no conv pads where 2^L divides D: the nested layout serves them all
        self.nested = embedding_size % (1 << len(self.convs)) == 0

    def _pairs(self, u: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
        """(n,) scores of the row pairs of u (n, D) and i (n, D)."""
        n = u.shape[0]
        if self.nested:
            x = nested_outer(u, i, len(self.convs))[..., None]       # (n, m, m, 4^L, 1)
            for conv in self.convs:
                x = torch.relu(conv_patches(x.reshape(*x.shape[:3], -1, 4 * x.shape[-1]), conv))
        else:
            x = (u[:, :, None] * i[:, None, :])[..., None]           # (n, D, D, 1)
            for conv in self.convs:
                x = torch.relu(patch_conv(x, conv))
        return self.out(x.reshape(n, -1)).squeeze(-1)

    def _score(self, users: torch.Tensor, items: torch.Tensor) -> torch.Tensor:
        return self._pairs(gather_rows(self.user_embedding.weight, users),
                           gather_rows(self.item_embedding.weight, items))

    def calculate_loss(self, batch: Batch) -> torch.Tensor:
        users = batch[self.uid_field]
        return bpr_loss(self._score(users, batch[self.iid_field]),
                        self._score(users, batch[self.neg_prefix + self.iid_field]),
                        batch.get("weight"))

    def predict(self, batch: Batch) -> torch.Tensor:
        return self._score(batch[self.uid_field], batch[self.iid_field])

    def full_sort_scores(self, batch: Batch) -> torch.Tensor:
        """(B, n_items) over blocks of items: a block holds at most
        `FULL_SORT_ELEMS` elements of the first conv's output."""
        u = self.user_embedding.weight[batch[self.uid_field].long()]
        B, D = u.shape

        def block(items):
            T = items.shape[0]
            i = self.item_embedding.weight[items]
            pairs = self._pairs(u[:, None].expand(B, T, D).reshape(B * T, D),
                                i[None].expand(B, T, D).reshape(B * T, D))
            return pairs.reshape(B, T)

        half = (D + 1) // 2
        per_item = B * max(D * D, half * half * self.cnn_channels[0])
        return score_item_blocks(self.n_items, per_item, u.device, block)


def elastic_net_gaps(X: torch.Tensor, W: torch.Tensor, l1: float, l2: float) -> torch.Tensor:
    """(n,) duality gap of each column's problem at W (formulation A,
    positive): min ½‖y_j − X_{-j}w‖² + l1‖w‖₁ + ½·l2‖w‖², y_j = X[:, j]."""
    R = X - X @ W
    r2 = (R * R).sum(dim=0)
    ry = (R * X).sum(dim=0)
    xta = X.T @ R - l2 * W
    xta.diagonal().zero_()  # feature j is absent from problem j
    dual_norm = xta.amax(dim=0)
    w_l1 = W.abs().sum(dim=0)
    w_l2 = (W * W).sum(dim=0)
    primal = 0.5 * (r2 + l2 * w_l2) + l1 * w_l1
    scale = torch.where(dual_norm > l1, l1 / dual_norm, torch.ones_like(dual_norm))
    dual = -0.5 * scale**2 * (r2 + l2 * w_l2) + scale * ry
    return primal - dual


@torch.no_grad()
def slim_elastic_solve(X: torch.Tensor, alpha: float = 0.2, l1_ratio: float = 0.02,
                       max_iter: int = 100, tol: float = 1e-4):
    """(W (n, n), info) for the (N, n) float32 0/1 matrix `X` on its
    device; `info`: the sweeps run, the columns stopped by the rule and
    those that reached `max_iter` (column 0 is in neither)."""
    N, n = X.shape
    l1 = alpha * l1_ratio * N
    l2 = alpha * (1.0 - l1_ratio) * N
    G = X.T @ X
    gdiag = torch.diagonal(G).tolist()
    tol_y = tol * torch.diagonal(G)  # tol · ‖y_j‖²
    W = torch.zeros((n, n), dtype=X.dtype, device=X.device)
    W_old = torch.empty_like(W)
    live = torch.ones(n, dtype=torch.bool, device=X.device)
    live[0] = False  # the JAX loop starts at item 1
    fitted = live.clone()
    live &= ~(elastic_net_gaps(X, W, l1, l2) <= tol_y)

    def sweep():
        W_old.copy_(W)
        for k in range(n):
            gkk = gdiag[k]
            if gkk == 0.0:
                continue
            rho = torch.add(G[k] - G[k] @ W, W[k], alpha=gkk)
            new = (rho - l1).clamp_(min=0.0).div_(gkk + l2)
            new[k:k + 1].zero_()  # a fill on the card: no host copy inside the capture
            torch.where(live, new, W[k], out=W[k])

    graph = None
    if X.device.type == "cuda":
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):  # the warm-up is the first sweep
            sweep()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):  # records the sweep, runs nothing
            sweep()
    sweeps = 0
    for it in range(max_iter):
        if it > 0 or graph is None:
            if not bool(live.any()):
                break
            if graph is None:
                sweep()
            else:
                graph.replay()
        sweeps += 1
        w_max = W.abs().amax(dim=0)
        d_max = (W - W_old).abs().amax(dim=0)
        check = (w_max == 0) | (d_max / w_max <= tol) | (it == max_iter - 1)
        live &= ~(check & (elastic_net_gaps(X, W, l1, l2) <= tol_y))
    return W, {"sweeps": sweeps, "stopped": int((fitted & ~live).sum()),
               "max_iter": int(live.sum())}


def slim_elastic_state(train_split, alpha: float = 0.2, l1_ratio: float = 0.02,
                       device="cpu") -> dict:
    """{"slim_W", "user_hist_matrix"} of a training split, solved on
    `device` (`more3.py:335-359` of the JAX package, by `sklearn` there);
    `slim_info` holds the solve's counts."""
    X = history_matrix(train_split)
    W, info = slim_elastic_solve(torch.from_numpy(X).to(resolve_device(device)),
                                 alpha, l1_ratio)
    return {"slim_W": W.cpu().numpy(), "user_hist_matrix": X, "slim_info": info}


@register_model
class SLIMElastic(HistoryProductRecommender):
    matrix = "slim_W"

    def __init__(self, n_users: int, n_items: int, embedding_size: int = 64, alpha: float = 0.2,
                 l1_ratio: float = 0.02, slim_W: Optional[np.ndarray] = None,
                 user_hist_matrix: Optional[np.ndarray] = None,
                 slim_info: Optional[dict] = None, **kwargs):
        super().__init__(n_users, n_items, embedding_size, **kwargs)
        self.alpha, self.l1_ratio = float(alpha), float(l1_ratio)
        self.slim_info = slim_info
        self._init_state(user_hist_matrix, slim_W)

    @staticmethod
    def build_estate(train_split, config=None) -> dict:
        kw = config_values(config, {"alpha": 0.2, "l1_ratio": 0.02})
        return slim_elastic_state(train_split, device=config["device"] if config else "cpu",
                                  **kw)
