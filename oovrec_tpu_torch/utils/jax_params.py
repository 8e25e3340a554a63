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

An optimizer state crosses too: `opt_state_from_flax` turns the state of
any chain the JAX trainer builds (`train/optimizers.py:build_optimizer`,
the clip wrapper, the torch-faithful Adam) into the port's state for the
same rule (`train/optimizers.py:Optimizer`): adam and lazy adam
``{"count", "mu", "nu"}`` with the shared count, the torch-faithful Adam
with a count a leaf, adagrad ``{"sum_of_squares"}``, rmsprop ``{"nu"}``,
sgd ``{}``.

The embedder state is not a parameter: the JAX package passes it as a
dict of numpy arrays (``estate``), the port holds it as the model's
``embedder_state`` buffers. `embedder_state_to_numpy` and
`set_embedder_state` cross it (the uint64 DHE keys as their int64 bits on
the port's side, int32 knn tables as int64), so both packages run from the
same planes, keys and neighbors; the param bridge leaves it alone. The
same holds for a model's own buffers that JAX keeps in ``estate``
(`MODEL_STATE`: the packed item features ``seq_feat_tokens`` of GRU4RecF,
SASRecF, FDSA and S3Rec; the general models' ``item_cnt``,
``user_hist_matrix``, ``item_sim``, ``ease_B``, ``slim_W``, ``admm_W``,
``plrec_scores``, the graph models' ``edge_src`` / ``edge_dst`` /
``edge_weight``, FISM's, NAIS's and ENMF's ``hist_items`` / ``hist_len``
and NNCF's ``user_neighbors`` / ``item_neighbors``; the knowledge models'
KGCN / KGNNLS neighbours ``kg_neighbors`` / ``kg_neighbor_rels``, KGAT's
collaborative graph ``ckg_src`` / ``ckg_dst`` / ``ckg_rel``, KGIN's and
MCCLK's ``kgin_*`` edges and RippleNet's numbered ripple sets
``ripple_{h,r,t}<hop>``, `is_model_state`): `set_embedder_state` loads
them, the bridge never carries them as params. The knowledge models'
trees cross like the others: KGAT's ``node_embedding`` (users first, then
entities), its raw ``trans_w`` and Denses ``w1_<i>`` / ``w2_<i>``, CKE's
raw ``trans_w``, MKR's ``cc_<i>`` raw vectors (``w_vv`` ... ``b_e``) and
KGIN's raw ``latent_emb`` and ``disen_weight_att``.

BatchNorm running statistics are not parameters either: flax keeps them
in the ``batch_stats`` collection (``{.../BatchNorm_j: {mean, var}}``, or
under the module's own name: NFM's ``bn`` and ``mlp_bn_<i>``), the port as
the ``mean`` / ``var`` buffers of its ``BatchNorm`` modules, which ride the
model's ``state_dict``. They are told by the owning module's type
(`_stat_keys`), whatever its name; without a module, by the leaf name
(no flax parameter is named ``mean`` or ``var``). `batch_stats_from_module`
and `load_batch_stats` cross them; the param bridge leaves them alone.

Nested trees cross by path: KD_DAGFM's ``student`` (raw ``connect_layer``,
``p_<i>``, ``q_<i>`` and a Dense ``out``) and ``teacher`` (Dense
``cross_<i>`` and ``out``), the attention layers' ``query`` / ``key`` /
``value`` / ``out`` (raw 3-D kernels, `models/layers.py:DenseGeneral`)
and the GRU cell's six Denses. The sequential models' trees cross the
same way: GRU4Rec's scanned cells ``gru_<i>`` (NARM's ``gru``) with the
six Denses, SASRec's and BERT4Rec's ``block_<i>`` with ``LayerNorm_0/1``
(``scale``, ``bias``), ``MultiHeadDotProductAttention_0`` and
``Dense_0/1``, their ``final_ln``, STAMP's raw ``b_a`` at the top and
FPMC's four tables ``UI`` / ``IU`` / ``LI`` / ``IL``; and the second
sequential slice's: the conv kernels of Caser (``hconv_<h>``,
``v_conv``) and NextItNet (``block_<i>/Conv_0/1``) in flax's layout (a
``kernel`` under a module that is not an ``nn.Linear`` is raw), DIEN's
scanned ``interest_gru``, SRGNN's ``gnn`` (``Dense_0/1``, ``GRUCell_0``),
GCSAN's ``attn_block``, LightSANs' ``attn_<i>``, and the raw leaves at
the top: HGN's ``b_g`` and ``w4_kernel``, FOSSIL's ``global_lambda``,
TransRec's ``global_t`` and ``item_bias``, SINE's ``prototypes``; and the
last seven's: GRU4RecF's scanned ``feature_gru``, FDSA's ``feat_block_<i>``
and ``feat_ln``, RepeatNet's ``gru`` and its bias-free Denses, GRU4RecKG's
``entity_gru``, the raw ``entity_embedding`` and ``relation_embedding``
of GRU4RecKG and KSR, and S3Rec's ``*_norm`` heads and its n_items + 1
item table. The general models' trees: the traditional models' raw
``dummy`` at the top, NGCF's ``gc_<i>`` / ``bi_<i>``, SpectralCF's
bias-free ``filter_<i>``, GCMC's bias-free ``gcn``, its ``dense`` and its
raw ``decoder_q`` (D, D), used as ``u @ q`` in flax's layout.

A ``kernel`` leaf is a Dense or a stored kernel depending on the port's
module, so trees with kernels cross with the target `module` given. A
model may rename top-level modules through a ``flax_names`` mapping
(torch name → flax name), as `ContextRecommender` does for ``fields``.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

FlaxParams = Mapping[str, Any]
STATE = "embedder_state"
# a model's own dataset-derived buffers, which the JAX package passes in
# `estate` beside the embedder state: the feature-fused models' packed
# item features, the general models' training statistics (Pop's counts,
# the history matrix, the item-item and score matrices of the host
# solves) and the graph models' edges
MODEL_STATE = frozenset({
    "seq_feat_tokens", "item_cnt", "user_hist_matrix", "item_sim", "ease_B", "slim_W",
    "admm_W", "plrec_scores", "edge_src", "edge_dst", "edge_weight", "hist_items", "hist_len",
    "user_neighbors", "item_neighbors", "kg_neighbors", "kg_neighbor_rels", "ckg_src",
    "ckg_dst", "ckg_rel", "kgin_head", "kgin_rel", "kgin_tail", "kgin_uid", "kgin_iid", "kgin_w",
})
# RippleNet's ripple sets, three arrays a hop: ripple_h0, ripple_r0, ...
NUMBERED_STATE = re.compile(r"ripple_[hrt]\d+")


def is_model_state(key: str) -> bool:
    """Whether `key` names one of a model's own dataset-derived buffers."""
    return key in MODEL_STATE or NUMBERED_STATE.fullmatch(key) is not None


def _is_state(key: str) -> bool:
    return key.split(".")[-2:-1] == [STATE] or is_model_state(key)


def _stat_keys(module: Optional[nn.Module], keys=()) -> set:
    """The state_dict keys that are BatchNorm running statistics: the
    ``mean`` / ``var`` buffers of every `models/layers.py:BatchNorm` in
    `module`, whatever the module's name; without a module, those of
    `keys` whose leaf is named ``mean`` or ``var``."""
    if module is None:
        return {k for k in keys if k.rsplit(".", 1)[-1] in ("mean", "var")}
    from oovrec_tpu_torch.models.layers import BatchNorm

    return {f"{name}.{b}" if name else b
            for name, m in module.named_modules() if isinstance(m, BatchNorm)
            for b in ("mean", "var")}


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
    stats = _stat_keys(module, sd)
    out: Dict[str, Any] = {}
    for key, value in sd.items():
        if _is_state(key) or key in stats:
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
    stats = _stat_keys(module)
    missing = [k for k in missing if not _is_state(k) and k not in stats]
    if missing or unexpected:
        raise KeyError(f"flax tree and module differ: missing {missing}, "
                       f"unexpected {unexpected}")
    return module


def batch_stats_from_module(module: nn.Module) -> Dict[str, Any]:
    """A copy of the port's BatchNorm running statistics as flax's
    ``batch_stats`` tree (``{"mlp_layers": {"BatchNorm_0": {"mean",
    "var"}}}``, NFM's ``{"bn": ..., "mlp_bn_0": ...}``)."""
    to_flax, _ = _renames(module)
    sd = module.state_dict()
    out: Dict[str, Any] = {}
    for key in sorted(_stat_keys(module)):
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
    want = _stat_keys(module)
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
    state, and the `MODEL_STATE` entries as the model's own buffers of
    those names (the buffers must exist with the same shapes); then the
    plans of its index buffers follow them."""
    buffers = dict(getattr(module, STATE).named_buffers())
    own = dict(module.named_buffers(recurse=False))
    buffers.update({k: v for k, v in own.items() if is_model_state(k)})
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
    refresh = getattr(module, "refresh_index_plans", None)
    if refresh is not None:  # the plans of edges just loaded (ops/embed_grad.py:IndexPlans)
        refresh()
    return module


# the state each rule of the port keeps: its keys in the JAX chain's
# element, and whether `count` there is one scalar (shared) or a tree
RULE_STATE = {
    "adam": ("count", "mu", "nu"),
    "lazy_adam": ("count", "mu", "nu"),
    "torch_adam": ("count", "mu", "nu"),
    "adagrad": ("sum_of_squares",),
    "rmsprop": ("nu",),
    "sgd": (),
}


def _state_dict(tree) -> Any:
    """An optax state as flax's `to_state_dict` gives it: a NamedTuple as
    a dict of its fields, a tuple as a dict of "0", "1", ...; a decoded
    checkpoint tree is already so."""
    if hasattr(tree, "_fields"):
        return {k: _state_dict(getattr(tree, k)) for k in tree._fields}
    if isinstance(tree, (tuple, list)):
        return {str(i): _state_dict(v) for i, v in enumerate(tree)}
    if isinstance(tree, Mapping):
        return {k: _state_dict(v) for k, v in tree.items()}
    return tree


def _rule_node(tree, keys):
    """The first element of the (nested) chain whose fields are `keys`."""
    if not isinstance(tree, Mapping):
        return None
    if set(tree) == set(keys):
        return tree
    for k in sorted(tree, key=lambda k: (len(k), k)):
        found = _rule_node(tree[k], keys)
        if found is not None:
            return found
    return None


def opt_state_from_flax(opt_state, rule: str, module: nn.Module) -> Dict[str, Any]:
    """A JAX optimizer state (the optax objects or a decoded checkpoint
    tree) of the chain for `rule` → the port's state for `module`: each
    param-shaped tree as a name → tensor dict on the module's device (the
    stored dtype's values; a bf16 first moment arrives as its f32 values),
    the shared count as an int, per-leaf counts as int32 tensors."""
    keys = RULE_STATE[rule]
    if not keys:
        return {}
    node = _rule_node(_state_dict(opt_state), keys)
    if node is None:
        raise KeyError(f"no {keys} element in the JAX optimizer state for rule [{rule}]")
    device = next(module.parameters()).device
    out: Dict[str, Any] = {}
    for part in keys:
        if part == "count" and rule != "torch_adam":
            out[part] = int(np.asarray(node[part]))
            continue
        tree = state_dict_from_flax(node[part], module)
        dtype = torch.int32 if part == "count" else torch.float32
        out[part] = {k: v.to(device=device, dtype=dtype) for k, v in tree.items()}
    return out
