"""SRGNN, GCSAN, LightSANs and SINE.

Port of `oovrec_tpu/models/sequential/more4.py:19-226`:
  * SRGNN: the positional session graph (B, L, L), an edge t → t + 1
    where both positions lie inside the sequence, its in and out
    adjacencies row-normalised; `step` rounds of `gnn` (`Dense_0` and
    `Dense_1` on the states, their in / out messages side by side as the
    2D input of `GRUCell_0`, the states its carry); then the last state
    and an additive attention over the states inside the sequence
    (`w1`, `w2`, `q`) through `w3`;
  * GCSAN: SRGNN's states through SASRec's block `attn_block` (its
    `n_heads`, `inner_size`, dropout 0) under the padding mask alone (the
    JAX docstring's "causal" is not in its code), the last position's
    output blended with the last state by `blend_weight`. SRGNN's
    readout (`w1`, `w2`, `q`, `w3`), never called, has no parameters in
    the flax tree, nor here;
  * LightSANs: item plus position rows; each layer projects the
    positions onto `k_interests` (`ip_<i>`, a softmax over the positions
    inside the sequence), attends from the positions to those interests
    (`attn_<i>`, flax attention, unmasked and without dropout), then
    `ln`(x + dropout(y)) and `ln`(x + gelu(`ffn_<i>`(x))) with the one
    `ln`; the state at length − 1;
  * SINE: an attentive pooling zu of the sequence, its similarity to the
    raw `prototypes`, each prototype gated by σ(similarity) where the
    similarity reaches the `interest_size`-th largest (ties pass the
    gate, as `lax.top_k`'s threshold lets them), the sequence pooled by
    its similarity to the gated mix over `tau`, then `w3`(out + zu).
"""

from __future__ import annotations

import torch
from torch import nn

from oovrec_tpu_torch.models.base import register_model
from oovrec_tpu_torch.models.context import dense, raw_param
from oovrec_tpu_torch.models.init import xavier_normal_
from oovrec_tpu_torch.models.layers import (
    Dropout,
    GRUCell,
    LayerNorm,
    MultiHeadDotProductAttention,
    TransformerBlock,
    gelu,
)
from oovrec_tpu_torch.models.sequential.base import SequentialRecommender, gather_last, inside
from oovrec_tpu_torch.ops.embed_grad import gather_rows


def session_adjacency(mask: torch.Tensor):
    """(B, L) float mask → the row-normalised (in, out) adjacencies of the
    edges t → t + 1 inside the sequence, each (B, L, L)."""
    L = mask.shape[1]
    nxt = torch.diag(torch.ones(L - 1, device=mask.device), 1)
    a_out = nxt[None] * (mask[:, :, None] * mask[:, None, :])
    a_in = a_out.transpose(1, 2)

    def norm(a):
        return a / torch.clamp(a.sum(dim=2, keepdim=True), min=1.0)

    return norm(a_in), norm(a_out)


class GNNCell(nn.Module):
    """SRGNN's gated step: messages along the in and out edges feed a
    flax `GRUCell` whose carry is the state."""

    def __init__(self, hidden_size: int, device=None, generator=None):
        super().__init__()
        D = hidden_size
        for name in ("Dense_0", "Dense_1"):
            lin = nn.Linear(D, D, device=device)
            xavier_normal_(lin.weight, generator)
            nn.init.zeros_(lin.bias)
            self.add_module(name, lin)
        self.GRUCell_0 = GRUCell(2 * D, D, device=device, generator=generator)

    def forward(self, a_in, a_out, h):
        inputs = torch.cat([a_in @ self.Dense_0(h), a_out @ self.Dense_1(h)], dim=-1)
        B, L, D = h.shape
        new_h, _ = self.GRUCell_0(h.reshape(B * L, D), inputs.reshape(B * L, -1))
        return new_h.reshape(B, L, D)


@register_model
class SRGNN(SequentialRecommender):
    def __init__(self, *args, step: int = 1, **kwargs):
        super().__init__(*args, **kwargs)
        D = self.embedding_size
        self.step = int(step)
        self.item_embedding = self._embed_table(self.n_items)
        self.gnn = GNNCell(D, device=self.device, generator=self.generator)
        self._readout()

    def _readout(self):
        D = self.embedding_size
        self.w1 = dense(self, D, D, bias=False)
        self.w2 = dense(self, D, D, bias=False)
        self.q = dense(self, D, 1, bias=False)
        self.w3 = dense(self, 2 * D, D, bias=False)

    def _states(self, batch):
        seq, lengths = self._sequence(batch)
        mask = inside(seq, lengths)
        h = gather_rows(self.item_embedding.weight, seq)
        a_in, a_out = session_adjacency(mask)
        for _ in range(self.step):
            h = self.gnn(a_in, a_out, h)
        return h, mask, lengths

    def seq_output(self, batch, train: bool = False):
        h, mask, lengths = self._states(batch)
        last = gather_last(h, lengths)
        alpha = self.q(torch.sigmoid(self.w1(last)[:, None, :] + self.w2(h))).squeeze(-1) * mask
        return self.w3(torch.cat([(alpha[:, :, None] * h).sum(dim=1), last], dim=-1))


@register_model
class GCSAN(SRGNN):
    def __init__(self, *args, blend_weight: float = 0.6, n_heads: int = 1,
                 inner_size: int = 256, **kwargs):
        self.blend_weight, self.n_heads, self.inner_size = float(blend_weight), n_heads, inner_size
        super().__init__(*args, **kwargs)

    def _readout(self):
        self.attn_block = TransformerBlock(self.n_heads, self.embedding_size, self.inner_size,
                                           0.0, device=self.device, generator=self.generator)

    def seq_output(self, batch, train: bool = False):
        h, mask, lengths = self._states(batch)
        a = self.attn_block(h, (mask > 0)[:, None, None, :], train)
        w = self.blend_weight
        return w * gather_last(a, lengths) + (1 - w) * gather_last(h, lengths)


@register_model
class LightSANs(SequentialRecommender):
    def __init__(self, *args, n_layers: int = 1, n_heads: int = 2, k_interests: int = 5,
                 inner_size: int = 256, dropout_prob: float = 0.4, **kwargs):
        super().__init__(*args, **kwargs)
        D = self.embedding_size
        self.item_embedding = self._embed_table(self.n_items)
        self.position_embedding = self._embed_table(self.max_seq_length)
        self.layers = []
        for i in range(n_layers):
            ip = dense(self, D, k_interests)
            attn = MultiHeadDotProductAttention(D, n_heads, D, device=self.device,
                                                generator=self.generator)
            ffn = dense(self, D, D)
            for name, m in (("ip", ip), ("attn", attn), ("ffn", ffn)):
                self.add_module(f"{name}_{i}", m)
            self.layers.append((ip, attn, ffn))
        self.ln = LayerNorm(D, device=self.device)
        self.drop = Dropout(dropout_prob)

    def seq_output(self, batch, train: bool = False):
        seq, lengths = self._sequence(batch)
        L = seq.shape[1]
        mask = inside(seq, lengths)
        x = gather_rows(self.item_embedding.weight, seq) + self.position_embedding.weight[:L]
        for ip, attn, ffn in self.layers:
            w = torch.softmax(ip(x).masked_fill(mask[:, :, None] == 0, -1e9), dim=1)
            interests = torch.einsum("blk,bld->bkd", w, x)
            x = self.ln(x + self.drop(attn(x, interests), train))
            x = self.ln(x + gelu(ffn(x)))
        return gather_last(x, lengths)


@register_model
class SINE(SequentialRecommender):
    def __init__(self, *args, prototype_size: int = 8, interest_size: int = 2, tau: float = 0.1,
                 **kwargs):
        super().__init__(*args, **kwargs)
        D = self.embedding_size
        self.interest_size, self.tau = int(interest_size), float(tau)
        self.item_embedding = self._embed_table(self.n_items)
        self.prototypes = raw_param(self, prototype_size, D)
        self.w1 = dense(self, D, D, bias=False)
        self.w2 = dense(self, D, 1, bias=False)
        self.w3 = dense(self, D, D, bias=False)

    def gate(self, su: torch.Tensor) -> torch.Tensor:
        """σ(su) where su reaches its row's `interest_size`-th largest
        value, else 0: ties at the threshold all pass."""
        thresh = torch.topk(su, self.interest_size, dim=1).values[:, -1:]
        return torch.sigmoid(su) * (su >= thresh)

    def seq_output(self, batch, train: bool = False):
        seq, lengths = self._sequence(batch)
        out_mask = inside(seq, lengths) == 0
        x = gather_rows(self.item_embedding.weight, seq)
        a = self.w2(torch.tanh(self.w1(x))).squeeze(-1).masked_fill(out_mask, -1e9)
        zu = (torch.softmax(a, dim=1)[:, :, None] * x).sum(dim=1)
        cu = self.gate(zu @ self.prototypes.T) @ self.prototypes
        pw = torch.softmax(((x * cu[:, None, :]).sum(dim=-1) / self.tau)
                           .masked_fill(out_mask, -1e9), dim=1)
        return self.w3((pw[:, :, None] * x).sum(dim=1) + zu)
