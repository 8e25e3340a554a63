"""One user's full-sort scores and top-k, from a model or a checkpoint.

Port of `oovrec_tpu/utils/case_study.py`. The port's model holds its
weights and its embedder state itself (parameters and buffers), so the
functions take the model where the JAX ones take `variables` and
`estate`. Scores come from `model.full_sort_scores` on the model's
device; column 0 (the padding item) and each user's history are set to
-inf, and the top-k is a stable descending sort, so ties go to the lowest
item index as in JAX's `argsort(-s, kind="stable")`.
"""

from __future__ import annotations

import numpy as np
import torch

from oovrec_tpu_torch.data.transfer import to_device_batch


def full_sort_scores(uid_list, model, hist_per_user=None) -> np.ndarray:
    """(len(uid_list), n_items) f32 host scores of the internal user ids,
    column 0 and each user's history in `hist_per_user` (uid → item ids)
    at -inf."""
    batch = to_device_batch({model.uid_field: np.asarray(uid_list, np.int64)}, model.device)
    with torch.no_grad():
        scores = model.full_sort_scores(batch).float().cpu().numpy().copy()
    scores[:, 0] = -np.inf
    if hist_per_user is not None:
        for i, u in enumerate(uid_list):
            hist = hist_per_user[int(u)]
            if len(hist):
                scores[i, np.asarray(hist)] = -np.inf
    return scores


def full_sort_topk(uid_list, model, k, hist_per_user=None):
    """→ (scores (n, k), item ids (n, k)) of each user's top k, ties to
    the lowest item id."""
    scores = full_sort_scores(uid_list, model, hist_per_user)
    idx = np.argsort(-scores, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(scores, idx, axis=1), idx


def case_study_from_checkpoint(user_tokens, model_file: str, k: int = 10):
    """A case study of external user tokens straight from a checkpoint:
    restore it (`cli/quick_start.py:load_data_and_model`), map the tokens
    to internal ids, mask each user's training history. → (scores (n, k),
    item tokens (n, k)) of the top k."""
    from oovrec_tpu_torch.cli.quick_start import load_data_and_model

    loaded = load_data_and_model(model_file)
    ds = loaded.dataset
    uids = np.asarray([ds.token2id(ds.uid_field, str(t)) for t in user_tokens], np.int64)
    train = loaded.train_loader.split
    uidx = np.asarray(train.inter[ds.uid_field])
    iidx = np.asarray(train.inter[ds.iid_field])
    hist = {int(u): iidx[uidx == u] for u in uids}
    scores, topk = full_sort_topk(uids, loaded.model, k, hist_per_user=hist)
    tokens = np.asarray(ds.id2token(ds.iid_field, topk.reshape(-1))).reshape(topk.shape)
    return scores, tokens
