"""BERT4Rec: a bidirectional transformer trained with the cloze loss.

Port of `oovrec_tpu/models/sequential/bert4rec.py:19-99`, on SASRec's
encoder (`sasrec.py`) with the padding mask alone. The item table has
n_items + 1 rows (the last is the mask token) and the position table
L + 1. Training reads the batch that `MaskItemSequence`
(`data/transform.py`) masked: CE over the real items at each row's
`mask_count` masked positions `mask_index`, against `mask_pos_items`,
rows weighted by `weight`. Inference writes the mask token at min(length,
L − 1) and reads its state: a full-length row's last item is overwritten,
as in the JAX package. The transform keeps BERT4Rec on the host path.
"""

from __future__ import annotations

import torch

from oovrec_tpu_torch.models.base import register_model
from oovrec_tpu_torch.parallel.train_step import batch_wmean
from oovrec_tpu_torch.models.sequential.sasrec import SASRec


@register_model
class BERT4Rec(SASRec):
    supports_device_epoch = False
    extra_item_rows = 1  # the mask token; and one more position

    def __init__(self, *args, n_layers: int = 2, n_heads: int = 2, inner_size: int = 256,
                 hidden_dropout_prob: float = 0.2, attn_dropout_prob: float = 0.2, **kwargs):
        super().__init__(*args, n_layers=n_layers, n_heads=n_heads, inner_size=inner_size,
                         hidden_dropout_prob=hidden_dropout_prob,
                         attn_dropout_prob=attn_dropout_prob, **kwargs)

    def mask(self, seq: torch.Tensor) -> torch.Tensor:
        return (seq != 0)[:, None, None, :]

    def _items(self) -> torch.Tensor:
        return self.item_embedding.weight[: self.n_items]

    def calculate_loss(self, batch):
        x = self.encode(batch[self.list_field], train=True)
        mask_index, pos_items = batch["mask_index"].long(), batch["mask_pos_items"].long()
        M = mask_index.shape[1]
        picked = x.gather(1, mask_index[:, :, None].expand(-1, -1, x.shape[-1]))
        logp = torch.log_softmax(picked @ self._items().T, dim=-1)
        nll = -logp.gather(2, pos_items[:, :, None]).squeeze(-1)
        valid = (torch.arange(M, device=x.device)[None, :]
                 < batch["mask_count"][:, None]).to(x.dtype)
        w = batch.get("weight")
        if w is not None:
            valid = valid * w[:, None]
        return batch_wmean(nll, valid)  # over the global batch's masked positions

    def seq_output(self, batch, train: bool = False):
        seq, lengths = self._sequence(batch)
        pos = torch.clamp(lengths.long(), max=seq.shape[1] - 1)[:, None]
        x = self.encode(seq.scatter(1, pos, self.n_items), train)
        return x.gather(1, pos[:, :, None].expand(-1, 1, x.shape[-1])).squeeze(1)

    def full_sort_scores(self, batch):
        return self.seq_output(batch) @ self._items().T
