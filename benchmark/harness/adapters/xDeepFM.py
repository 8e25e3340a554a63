"""xDeepFM over labelled rows with user and item features
(`xDeepFM.yaml`)."""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from benchmark.harness import generate
from benchmark.harness.models import inductive_spec, spec_of
from benchmark.reference import xdeepfm as ref_xdeepfm


class Adapter:
    dropout = True

    def __init__(self, cfg: dict):
        self.cfg = cfg
        self.corpus = cfg["corpus"]
        self.schema = self.corpus["schema"]
        self.masked_columns = ("user_id", "item_id", *self.schema["row_features"])

    def fields(self):
        from oovrec_tpu_torch.models.context import FieldSpec

        s = self.schema
        return FieldSpec(token_names=tuple(s["token_fields"]), token_dims=tuple(s["token_dims"]),
                         float_names=tuple(s["float_fields"]), float_dims=tuple(s["float_dims"]),
                         user_token_idx=tuple(s["user_token_idx"]),
                         item_token_idx=tuple(s["item_token_idx"]))

    def build(self, device):
        from oovrec_tpu_torch.models.context_aware.xdeepfm import xDeepFM

        a = self.cfg["model_args"]
        return xDeepFM(self.fields(), embedding_size=a["embedding_size"],
                       spec=inductive_spec(self.cfg), mlp_hidden_size=tuple(a["mlp_hidden_size"]),
                       reg_weight=a["reg_weight"], dropout_prob=a["dropout_prob"],
                       direct=a["direct"], cin_layer_size=tuple(a["cin_layer_size"]),
                       device=device)

    def train_loader(self, seed: int, port_cfg, mix: dict):
        """The IV rows of the first `train_fraction` of the labelled rows."""
        from oovrec_tpu_torch.data.dataloader import TrainBatcher
        from oovrec_tpu_torch.data.dataset import DatasetSplit
        from oovrec_tpu_torch.utils.enums import InputType

        c = self.corpus
        rows, user_feat, item_feat = generate.ctr_rows(c, seed)
        n = len(rows["label"])
        keep = ((np.arange(n) < int(mix["train_fraction"] * n))
                & (rows["user_id"] < c["n_old_users"]) & (rows["item_id"] < c["n_old_items"]))
        split = DatasetSplit({k: v[keep] for k, v in rows.items()}, c["n_old_users"],
                             c["n_old_items"], user_feat=user_feat, item_feat=item_feat)
        self.tables = (user_feat, item_feat)
        return TrainBatcher(split, None, port_cfg, InputType.POINTWISE)

    def reference_loss(self):
        return ref_xdeepfm.loss, {"spec": spec_of(self.cfg), "schema": self.schema,
                                  "model": self.cfg["model_args"]}

    def _joined(self, batch: dict):
        """Each user and item feature column as the benchmark's tables give
        it for the batch's ids → {field: (ids, table values)}."""
        user_feat, item_feat = self.tables
        out = {}
        for table, key in ((user_feat, "user_id"), (item_feat, "item_id")):
            ids = batch[key].long().cpu().numpy()
            for f, col in table.items():
                if f != key:
                    out[f] = (ids, np.asarray(col)[ids])
        return out

    def reference_batch(self, batch: dict, stage: str) -> dict:
        """The batch's feature columns joined by the reference from the
        benchmark's tables by the rows' ids (the program joined its own). In
        a simulated step the simulation zeroes entries at random: an entry
        the program gives as 0 stays 0, an entry of a row whose id was
        zeroed keeps the program's value (nothing names its row), and
        every other entry is the table's."""
        out = dict(batch)
        dev = batch["user_id"].device
        for f, (ids, values) in self._joined(batch).items():
            if stage == "oov":
                prog = batch[f].long().cpu().numpy()
                values = np.where(prog == 0, 0, np.where(ids == 0, prog, values))
            out[f] = torch.from_numpy(values).to(dev)
        return out

    def checks(self, stages: Dict[str, dict]) -> Dict[str, float]:
        """`oov.features_off`: the entries of the simulated steps' user and
        item feature columns that are neither 0 nor the table's value for the
        row's id (rows whose id was zeroed left out)."""
        off = 0
        for b in stages["oov"]["batches"]:
            w = b["weight"].cpu().numpy() > 0
            for f, (ids, values) in self._joined(b).items():
                prog = b[f].long().cpu().numpy()
                off += int(((prog != 0) & (prog != values) & (ids != 0) & w).sum())
        return {"oov.features_off": float(off)}

    def gathers(self, batch: dict) -> List[tuple]:
        """The program's row gathers of one training step, for the field
        embeddings (width D) and the first-order term (width 1): the packed
        token fields (the user and item cells left out), the user and item
        cells through their IV slice and their bucket table, the float
        fields where there are any."""
        s, p = self.schema, self.cfg["port"]
        c = self.corpus
        dims = s["token_dims"]
        offsets = np.concatenate([[0], np.cumsum(dims)[:-1]])
        B = batch["user_id"].shape[0]
        out = []
        for width in (self.cfg["model_args"]["embedding_size"], 1):
            toks = torch.stack([batch[f].long().clamp(max=d - 1) + int(o)
                                for f, d, o in zip(s["token_fields"], dims, offsets)], dim=1)
            live = torch.ones_like(toks, dtype=torch.bool)
            live[:, :2] = False
            out.append((toks.reshape(-1), live.reshape(-1), int(sum(dims)), width))
            for field, side in (("user_id", "user"), ("item_id", "item")):
                ids = batch[field]
                f = batch.get(field + "_oov")
                n_rows = c[f"n_old_{side}s"]
                new = (ids >= n_rows) if f is None else ((ids >= n_rows) | (f > 0))
                out.append((ids, ~new, n_rows, width))
                out.append((batch.get(field + "_bucket", torch.zeros_like(ids)), new,
                            p[f"n_{side}_oov_buckets"], width))
            if s["float_fields"]:
                fb = torch.stack([batch[f + "__bucket"].long() + int(o) for f, o in zip(
                    s["float_fields"], np.concatenate([[0], np.cumsum(s["float_dims"])[:-1]]))],
                    dim=1)
                out.append((fb.reshape(-1), torch.ones(B * len(s["float_fields"]),
                                                        dtype=torch.bool, device=fb.device),
                            int(sum(s["float_dims"])), width))
        return out
