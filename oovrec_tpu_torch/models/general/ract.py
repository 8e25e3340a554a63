"""RaCT: MultiVAE's actor trained against a learned NDCG critic.

Port of `oovrec_tpu/models/general/ract.py:31-125`. Each step keeps each
entry of the user's row with probability 1 − `mask_ratio` (a Bernoulli
mask from the trainer's dropout generator, drawn before the actor's own
keep mask and ε, as the JAX model draws them); the kept part is the
actor's input, the rest the held-out items. The three `train_stage`s:
  * `actor_pretrain`: the actor's MultiVAE loss on the kept part (the
    likelihood over the whole row);
  * `critic_pretrain`: the critic, a 3 → `critic_layers` → 1 MLP of raw
    `critic_w<i>` / `critic_b<i>` (relu, then a sigmoid) over the
    detached features (kept count, held-out count, the actor's loss)
    standardised over the batch (ddof 0, as `jnp.std`; `torch.std`'s
    default is the unbiased estimate), fits the actor's NDCG@`metrics_k`
    of the held-out items (detached) in squared error;
  * `finetune`: the actor maximises the critic's score, the critic's
    parameters detached.
In each stage the parameters it detaches, and those it does not read,
get a zero gradient. The NDCG ranks the logits with the kept items at
−inf by `torch.topk` (the JAX model's `lax.top_k`): the kept items carry
no held-out mass, so their order among themselves cannot change it.
The standardisation counts every row of the batch, a padded one too, as
the JAX model's does; under the mesh its moments are the global batch's.
"""

from __future__ import annotations

from typing import Sequence

import torch

from oovrec_tpu_torch.models.base import Batch, register_model
from oovrec_tpu_torch.models.context import raw_param
from oovrec_tpu_torch.models.general.more import MultiVAE, gaussian_kl, multinomial_nll
from oovrec_tpu_torch.models.losses import _wmean
from oovrec_tpu_torch.parallel.train_step import batch_mean, batch_std

STAGES = ("actor_pretrain", "critic_pretrain", "finetune")


@register_model
class RaCT(MultiVAE):
    def __init__(self, n_users: int, n_items: int, embedding_size: int = 64,
                 train_stage: str = "actor_pretrain",
                 critic_layers: Sequence[int] = (100, 100, 10), metrics_k: int = 100,
                 mask_ratio: float = 0.5, **kwargs):
        if train_stage not in STAGES:
            raise ValueError(f"RaCT: train_stage [{train_stage}] is not one of {STAGES}")
        super().__init__(n_users, n_items, embedding_size, **kwargs)
        self.train_stage = train_stage
        self.metrics_k, self.mask_ratio = int(metrics_k), float(mask_ratio)
        dims = (3,) + tuple(int(c) for c in critic_layers) + (1,)
        self.n_critic = len(dims) - 1
        for i, (d_in, d_out) in enumerate(zip(dims[:-1], dims[1:])):
            setattr(self, f"critic_w{i}", raw_param(self, d_in, d_out))
            setattr(self, f"critic_b{i}",
                    torch.nn.Parameter(torch.zeros(d_out, device=self.device)))

    def critic(self, feats: torch.Tensor, freeze: bool) -> torch.Tensor:
        """(B,) scores of the (B, 3) features, standardised over the (global)
        batch."""
        h = (feats - batch_mean(feats, dim=0, keepdim=True)) / (batch_std(feats) + 1e-6)
        for i in range(self.n_critic):
            w, b = getattr(self, f"critic_w{i}"), getattr(self, f"critic_b{i}")
            if freeze:
                w, b = w.detach(), b.detach()
            h = h @ w + b
            h = torch.relu(h) if i < self.n_critic - 1 else torch.sigmoid(h)
        return h.squeeze(-1)

    def actor_pieces(self, hist: torch.Tensor, keep: torch.Tensor):
        """The actor on the kept part: (per-user loss, logits, kept,
        held out, kept count, held-out count)."""
        seen, unseen = hist * keep, hist * (1.0 - keep)
        logits, mu, logvar = self.forward(seen, train=True)
        actor_loss = multinomial_nll(logits, hist) + self.anneal_cap * gaussian_kl(mu, logvar)
        return (actor_loss, logits, seen, unseen, (seen != 0).sum(dim=1).float(),
                (unseen != 0).sum(dim=1).float())

    def ndcg(self, logits: torch.Tensor, unseen: torch.Tensor, seen: torch.Tensor):
        """(B,) NDCG@k of the logits against the held-out items, the kept
        ones ranked last."""
        k = min(self.metrics_k, logits.shape[1])
        masked = logits.masked_fill(seen != 0, float("-inf"))
        top = torch.topk(masked, k, dim=1).indices
        tp = 1.0 / torch.log2(torch.arange(2, k + 2, device=logits.device, dtype=logits.dtype))
        dcg = (unseen.gather(1, top) * tp).sum(dim=1)
        n_rel = (unseen > 0).sum(dim=1)
        idcg = torch.cumsum(tp, dim=0)[torch.clamp(n_rel.clamp(max=k) - 1, 0, k - 1)]
        idcg = torch.where(n_rel > 0, idcg, torch.zeros_like(idcg))
        return dcg / torch.clamp(idcg, min=0.1)

    def calculate_loss(self, batch: Batch) -> torch.Tensor:
        hist = self.history(batch[self.uid_field])
        keep = self.draws.keep(1.0 - self.mask_ratio, hist.shape, hist.device)
        actor_loss, logits, seen, unseen, n_seen, n_unseen = self.actor_pieces(hist, keep)
        w = batch.get("weight")
        if self.train_stage == "actor_pretrain":
            return _wmean(actor_loss, w)
        feats = torch.stack([n_seen, n_unseen, actor_loss], dim=1)
        if self.train_stage == "critic_pretrain":
            y = self.critic(feats.detach(), freeze=False)
            score = self.ndcg(logits, unseen, seen).detach()
            return _wmean((y - score) ** 2, w)
        return _wmean(-self.critic(feats, freeze=True), w)
