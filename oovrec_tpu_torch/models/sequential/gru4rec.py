"""GRU4Rec: GRUs over the item embeddings; the last position's state
scores the items.

Port of `oovrec_tpu/models/sequential/gru4rec.py:18-56`: `num_layers`
flax `GRUCell`s scanned over the L positions (`models/layers.py:GRUCell`
and `gru_scan`, each carry starting at zeros as `initialize_carry` gives),
then `dense` back to the embedding width, then the state at length − 1.
`torch.nn.GRU` and cuDNN are not used: their recurrent r and z biases
would train where flax's cell has none. The cells are `gru_<i>`, as in
the flax tree.
"""

from __future__ import annotations

from oovrec_tpu_torch.models.base import register_model
from oovrec_tpu_torch.models.context import dense
from oovrec_tpu_torch.models.layers import Dropout, GRUCell, gru_scan
from oovrec_tpu_torch.models.sequential.base import SequentialRecommender, gather_last
from oovrec_tpu_torch.ops.embed_grad import gather_rows


@register_model
class GRU4Rec(SequentialRecommender):
    # the loss reads only split columns (+ a sampled negative): device-epoch OK
    supports_device_epoch = True

    def __init__(self, *args, hidden_size: int = 128, num_layers: int = 1,
                 dropout_prob: float = 0.3, **kwargs):
        super().__init__(*args, **kwargs)
        self.item_embedding = self._embed_table(self.n_items)
        self.gru_layers = []
        for i in range(num_layers):
            cell = GRUCell(self.embedding_size if i == 0 else hidden_size, hidden_size,
                           device=self.device, generator=self.generator)
            self.add_module(f"gru_{i}", cell)
            self.gru_layers.append(cell)
        self.dense = dense(self, hidden_size, self.embedding_size)
        self.emb_dropout = Dropout(dropout_prob)

    def seq_output(self, batch, train: bool = False):
        seq, lengths = self._sequence(batch)
        x = self.emb_dropout(gather_rows(self.item_embedding.weight, seq), train)
        for cell in self.gru_layers:
            _, x = gru_scan(cell, x, x.new_zeros(x.shape[0], cell.features))
        return gather_last(self.dense(x), lengths)
