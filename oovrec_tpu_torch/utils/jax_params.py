"""Weight bridge between the JAX package's flax params and a port module.

Works on numpy arrays only; it never imports flax or JAX. A flax param
tree is a nested dict of modules whose leaves are arrays; a torch
state_dict names the same leaves with dotted paths. The layout rules
follow `oovrec_tpu/utils/torch_import.py:10-14`:

  * a flax embedding ``{"embedding": W}`` is torch's ``<path>.weight``
    (W unchanged);
  * a flax ``nn.Dense`` ``{"kernel": K (in, out), "bias": b}`` is an
    ``nn.Linear``'s ``<path>.weight`` (Kᵀ, (out, in)) and ``<path>.bias``;
  * every other leaf (xDeepFM's ``CinConv`` ``kernel`` (H·F, L) and
    ``bias``, the first-order ``bias``, a BatchNorm's ``scale`` and
    ``bias``) keeps its name and its array; so does a raw leaf at the top
    of the tree (DCNv2's ``cross_layer_w`` (L, d, d), used as (out, in),
    ``cross_layer_u/v/c`` and ``cross_bias``).

DCNv2's ``gating_<i>`` Denses are ``nn.Linear``s and cross transposed.

The embedder towers (``user_oov_mlp`` / ``item_oov_mlp``, flax
``Dense_<j>``) are ``nn.Linear``s, so their kernels cross transposed.

An optimizer state crosses too: `lazy_adam_state_from_flax` turns the JAX
package's ``chain(scale_by_lazy_adam(), scale(-lr))`` state (count, mu and
nu trees) into the port's ``{"count", "mu", "nu"}``.

The embedder state is not a parameter: the JAX package passes it as a
dict of numpy arrays (``estate``), the port holds it as the model's
``embedder_state`` buffers. `embedder_state_to_numpy` and
`set_embedder_state` cross it (the uint64 DHE keys as their int64 bits on
the port's side, int32 knn tables as int64), so both packages run from the
same planes, keys and neighbors; the param bridge leaves it alone.

BatchNorm running statistics are not parameters either: flax keeps them
in the ``batch_stats`` collection (``{.../BatchNorm_j: {mean, var}}``), the
port as the ``mean`` / ``var`` buffers of its ``BatchNorm`` modules, which
ride the model's ``state_dict``. `batch_stats_from_module` and
`load_batch_stats` cross them; the param bridge leaves them alone.

A ``kernel`` leaf is a Dense or a stored kernel depending on the port's
module, so trees with kernels cross with the target `module` given. A
model may rename top-level modules through a ``flax_names`` mapping
(torch name → flax name), as `ContextRecommender` does for ``fields``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

FlaxParams = Mapping[str, Any]
STATE = "embedder_state"


def _is_state(key: str) -> bool:
    return key.split(".")[-2:-1] == [STATE]


def _is_stat(key: str) -> bool:
    """A BatchNorm running statistic (`BatchNorm_<j>.mean` / `.var`, the
    flax module names the port keeps)."""
    parts = key.split(".")
    return len(parts) >= 2 and parts[-2].startswith("BatchNorm_") and parts[-1] in ("mean", "var")


def _renames(module: Optional[nn.Module]):
    to_flax = dict(getattr(module, "flax_names", {}) or {})
    return to_flax, {v: k for k, v in to_flax.items()}


def _submodule(module: Optional[nn.Module], path: str) -> Optional[nn.Module]:
    if module is None:
        return None
    try:
        return module.get_submodule(path)
    except AttributeError:
        return None


def state_dict_from_flax(
    params: FlaxParams, module: Optional[nn.Module] = None,
) -> Dict[str, torch.Tensor]:
    """flax param tree → torch state_dict (for `module`, where the tree has
    kernels)."""
    _, from_flax = _renames(module)
    sd: Dict[str, torch.Tensor] = {}

    def walk(tree: Mapping[str, Any], path: str) -> None:
        for name, value in tree.items():
            if isinstance(value, Mapping):
                top = from_flax.get(name, name) if not path else name
                walk(value, f"{path}.{top}" if path else top)
                continue
            arr = np.array(value, dtype=np.float32)
            if not path:  # a raw parameter of the model itself
                sd[name] = torch.from_numpy(arr)
            elif name == "embedding":
                sd[f"{path}.weight"] = torch.from_numpy(arr)
            elif name == "kernel":
                sub = _submodule(module, path)
                if sub is None:
                    raise ValueError(
                        f"flax module [{path}] has a kernel; the bridge needs "
                        "the target module to place it"
                    )
                if isinstance(sub, nn.Linear):
                    sd[f"{path}.weight"] = torch.from_numpy(arr.T.copy())
                else:
                    sd[f"{path}.kernel"] = torch.from_numpy(arr)
            else:
                sd[f"{path}.{name}"] = torch.from_numpy(arr)

    walk(params, "")
    return sd


def flax_from_state_dict(
    sd: Mapping[str, torch.Tensor], module: Optional[nn.Module] = None,
) -> Dict[str, Any]:
    """torch state_dict → flax param tree. Without `module` every
    ``weight`` is an embedding table."""
    to_flax, _ = _renames(module)
    out: Dict[str, Any] = {}
    for key, value in sd.items():
        if _is_state(key) or _is_stat(key):
            continue
        arr = value.detach().cpu().numpy()
        if "." not in key:
            out[key] = arr
            continue
        path, leaf = key.rsplit(".", 1)
        if leaf == "weight":
            if isinstance(_submodule(module, path), nn.Linear):
                leaf, arr = "kernel", arr.T.copy()
            else:
                leaf = "embedding"
        parts = path.split(".")
        parts[0] = to_flax.get(parts[0], parts[0])
        node = out
        for p in parts:
            node = node.setdefault(p, {})
        node[leaf] = arr
    return out


def load_flax_params(module: nn.Module, params: FlaxParams) -> nn.Module:
    """Load a flax param tree into `module` (every parameter must match;
    the embedder state and the BatchNorm statistics stay as they are)."""
    sd = state_dict_from_flax(params, module)
    device = next(module.parameters()).device
    missing, unexpected = module.load_state_dict(
        {k: v.to(device) for k, v in sd.items()}, strict=False)
    missing = [k for k in missing if not _is_state(k) and not _is_stat(k)]
    if missing or unexpected:
        raise KeyError(f"flax tree and module differ: missing {missing}, "
                       f"unexpected {unexpected}")
    return module


def batch_stats_from_module(module: nn.Module) -> Dict[str, Any]:
    """A copy of the port's BatchNorm running statistics as flax's
    ``batch_stats`` tree (``{"mlp_layers": {"BatchNorm_0": {"mean",
    "var"}}}``)."""
    to_flax, _ = _renames(module)
    sd = module.state_dict()
    out: Dict[str, Any] = {}
    for key in filter(_is_stat, sd):
        parts = key.split(".")
        parts[0] = to_flax.get(parts[0], parts[0])
        node = out
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = sd[key].detach().cpu().numpy().copy()
    return out


def load_batch_stats(module: nn.Module, stats: FlaxParams) -> nn.Module:
    """Give `module`'s BatchNorms flax's ``batch_stats`` (every BatchNorm
    must have its pair, and the tree nothing else)."""
    flat = state_dict_from_flax(stats, module)
    sd = module.state_dict()
    want = set(filter(_is_stat, sd))
    if set(flat) != want:
        raise KeyError(f"batch_stats and module differ: {sorted(set(flat) ^ want)}")
    with torch.no_grad():
        for k, v in flat.items():
            sd[k].copy_(v)
    return module


def embedder_state_to_numpy(module: nn.Module) -> Dict[str, np.ndarray]:
    """The model's embedder state as the JAX package's ``estate``: float32
    arrays, int32 knn tables, uint64 DHE keys, int64 counts."""
    out: Dict[str, np.ndarray] = {}
    for k, v in getattr(module, STATE).named_buffers():
        arr = v.detach().cpu().numpy()
        if k == "dhe_keys":
            arr = arr.view(np.uint64)
        elif k.endswith("_knn_neighbors"):
            arr = arr.astype(np.int32)
        out[k] = arr
    return out


def set_embedder_state(module: nn.Module, estate: Mapping[str, Any]) -> nn.Module:
    """Give `module` the JAX package's ``estate`` arrays as its embedder
    state (the buffers must exist with the same shapes)."""
    buffers = dict(getattr(module, STATE).named_buffers())
    for k, v in estate.items():
        if k not in buffers:
            continue  # JAX-only entries (the uint32 key parts of the TPU hash)
        arr = np.asarray(v)
        if arr.dtype == np.uint64:
            arr = arr.view(np.int64)
        t = buffers[k]
        if tuple(arr.shape) != tuple(t.shape):
            raise ValueError(f"embedder state [{k}]: {arr.shape} for {tuple(t.shape)}")
        t.copy_(torch.as_tensor(arr).to(t.dtype))
    return module


def lazy_adam_state_from_flax(opt_state, module: nn.Module) -> Dict[str, Any]:
    """A JAX ``chain(scale_by_lazy_adam(), scale(-lr))`` state (its first
    element has ``count``, ``mu`` and ``nu``: the moments as param-shaped
    trees of arrays) → the port's lazy-Adam state for `module`: the shared
    count as an int and the moments as name → tensor dicts on the module's
    device."""
    lazy = opt_state[0] if isinstance(opt_state, (tuple, list)) else opt_state
    device = next(module.parameters()).device
    moments = {
        part: {k: v.to(device) for k, v in
               state_dict_from_flax(getattr(lazy, part), module).items()}
        for part in ("mu", "nu")
    }
    return {"count": int(np.asarray(lazy.count)), **moments}
