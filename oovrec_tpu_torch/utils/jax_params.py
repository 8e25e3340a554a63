"""Weight bridge between the JAX package's flax params and a port module.

Works on numpy arrays only; it never imports flax or JAX. The layout rule
follows `oovrec_tpu/utils/torch_import.py:10-14`: a flax embedding
``{"embedding": W}`` is torch's ``<name>.weight`` (W, unchanged), so
`BPR`'s `user_embedding` / `item_embedding` / `user_oov_buckets` /
`item_oov_buckets` tables cross as they are. Dense layers
(``kernel``/``bias``) come with the first ported model that has them.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

FlaxParams = Mapping[str, Mapping[str, np.ndarray]]


def state_dict_from_flax(params: FlaxParams) -> Dict[str, torch.Tensor]:
    """flax param tree (module → {"embedding": array}) → torch state_dict."""
    sd: Dict[str, torch.Tensor] = {}
    for module, leaves in params.items():
        if set(leaves) != {"embedding"}:
            raise ValueError(
                f"flax module [{module}] has leaves {sorted(leaves)}; "
                "the bridge carries embedding tables only"
            )
        sd[f"{module}.weight"] = torch.from_numpy(
            np.array(leaves["embedding"], dtype=np.float32)
        )
    return sd


def flax_from_state_dict(
    sd: Mapping[str, torch.Tensor],
) -> Dict[str, Dict[str, np.ndarray]]:
    """torch state_dict of embedding tables → flax param tree."""
    out: Dict[str, Dict[str, np.ndarray]] = {}
    for key, value in sd.items():
        module, leaf = key.rsplit(".", 1)
        if leaf != "weight":
            raise ValueError(f"state_dict key [{key}] is not an embedding table")
        out[module] = {"embedding": value.detach().cpu().numpy()}
    return out
