"""The JAX package's checkpoints, read without JAX, flax or the JAX package.

`Trainer._save_checkpoint` of the JAX package (`train/trainer.py:851-881`
there) pickles a dict: `config` (plain values and two of its enums),
`epoch`, `cur_step`, `best_valid_score`, `params`, `extra_vars` and
`opt_state` as flax msgpack bytes, and `estate` as numpy arrays. The
pickle is read with an unpickler that builds only numpy arrays and
scalars, an `OrderedDict` and the JAX package's enums, taken as the
port's enums of the same name (`utils/enums.py`): nothing else of the
pickle runs. The msgpack trees are decoded by `utils/flax_msgpack.py`.

A pickle whose trees hold row-sharded tables (`embedding_sharded`, the
(S, V/S, D) layout of a run under `sharded_lookup: psum|alltoall`) reads
like any other; the trainer converts the layout to the model's
(`parallel/sharded_embedding.py:reconcile_layouts`).

The orbax format (`checkpoint_format: orbax`, a pickle whose `__orbax__`
entry names tree directories beside it, `train/checkpoint.py:74-80` there)
stays refused with NotImplementedError: its trees are OCDBT / tensorstore
directories, for which there is no numpy reader, and the card's machine
has no tensorstore. The JAX trainer itself pickles its checkpoints
(`trainer.py:851-881` there).

A file that `torch.save` wrote is a zip archive; `is_jax_checkpoint`
tells the two apart.
"""

from __future__ import annotations

import io
import pickle
import zipfile
from typing import Any, Dict

from oovrec_tpu_torch.utils import enums
from oovrec_tpu_torch.utils.flax_msgpack import msgpack_restore

JAX_ENUMS = "oovrec_tpu.utils.enums"
# what a numpy array, a numpy scalar and an ordered dict pickle through
SAFE_GLOBALS = frozenset({
    ("collections", "OrderedDict"),
    ("numpy", "dtype"),
    ("numpy", "ndarray"),
    ("numpy.core.multiarray", "_reconstruct"),
    ("numpy.core.multiarray", "scalar"),
    ("numpy._core.multiarray", "_reconstruct"),
    ("numpy._core.multiarray", "scalar"),
})


class _Unpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        if module == JAX_ENUMS and isinstance(getattr(enums, name, None), type):
            return getattr(enums, name)
        if (module, name) in SAFE_GLOBALS:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"a JAX checkpoint holds no {module}.{name}; refusing to load it")


def is_jax_checkpoint(path: str) -> bool:
    """Whether `path` is a JAX package pickle (not a `torch.save` zip)."""
    return not zipfile.is_zipfile(path)


def read_jax_checkpoint(path: str) -> Dict[str, Any]:
    """The checkpoint's dict, its `params`, `extra_vars` and `opt_state`
    decoded to state-dict trees of numpy arrays (`extra_vars` {} where it
    holds none)."""
    with open(path, "rb") as f:
        state = _Unpickler(io.BytesIO(f.read())).load()
    if isinstance(state, dict) and "__orbax__" in state:
        raise NotImplementedError(
            f"{path} is an orbax checkpoint: its trees are OCDBT / tensorstore directories, "
            "which have no numpy reader, and the port has no tensorstore (ROADMAP.md, "
            "section 3); the JAX trainer's own pickle checkpoints read")
    if not isinstance(state, dict) or "params" not in state:
        raise ValueError(f"{path} is not a checkpoint of the JAX package's trainer")
    out = dict(state)
    for key in ("params", "extra_vars", "opt_state"):
        raw = state.get(key)
        out[key] = msgpack_restore(raw) if raw else {}
    out["estate"] = dict(state.get("estate") or {})
    return out
