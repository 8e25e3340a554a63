"""Dataset: atomic files → filtered, ID-remapped numpy arrays + splits.

Port of `oovrec_tpu/data/dataset.py` (`Dataset`, `DatasetSplit` and the
split helpers) without pandas: a table is an ordered dict of equal-length
numpy arrays (token columns as object arrays of str until the remap, then
int64; floats as float64; sequence columns as object arrays of arrays).
The steps and their order are the JAX package's:

  * filtering (`_data_filtering`): rows with a missing user or item id,
    `rm_dup_inter`, `val_interval` on every table holding the field, the
    drop of interactions whose user or item has no feature row, then the
    iterative k-core (`user_inter_num_interval` / `item_inter_num_interval`),
    which also bans feature-only ids when the interval excludes 0;
  * the remap (`_remap_fields`) in first-appearance order with ``[PAD]`` = 0,
    interaction columns before user and item feature columns, alias groups
    first; a missing token cell is the token ``"nan"``, as `astype(str)`
    makes it there;
  * `_remove_new_samples` (is_new == '1' rows go, after the remap), the
    dense reindex of the feature tables, `_fill_nan` (PAD for tokens, the
    column mean for floats, summed as pandas sums it), the label by
    threshold, min-max `_normalize` and `_discretization`;
  * `build` with RS / LS splits, order RO / TO (TO is the fork's no-op
    here, a time sort in `InductiveDataset`) and group_by user / None.

The views (`DatasetSplit`) hold the interaction rows as arrays: tokens
int64, floats float32, sequences padded with a `<field>_len` column.
"""

from __future__ import annotations

import os
import re
from collections import Counter, OrderedDict
from typing import Dict, List, Optional

import numpy as np

from oovrec_tpu_torch.data.atomic import load_atomic_file
from oovrec_tpu_torch.utils.enums import FeatureSource, FeatureType
from oovrec_tpu_torch.utils.seeding import host_rng

Table = Dict[str, np.ndarray]


def _parse_interval(s: Optional[str]):
    """'[A,B)' style interval strings, incl. ';'-separated unions like
    '(-inf,4);(4,inf)' → a list of (lo, hi, lo_inc, hi_inc)."""
    if not s:
        return None
    parts = []
    for piece in str(s).split(";"):
        m = re.fullmatch(
            r"\s*([\[(])\s*([^,]+)\s*,\s*([^)\]]+)\s*([)\]])\s*", piece
        )
        if not m:
            raise ValueError(f"Invalid interval: {s!r}")
        parts.append((float(m.group(2)), float(m.group(3)),
                      m.group(1) == "[", m.group(4) == "]"))
    return parts


def _in_interval(x: np.ndarray, ivs) -> np.ndarray:
    out = np.zeros(len(x), bool)
    for lo, hi, lo_inc, hi_inc in ivs:
        left = x >= lo if lo_inc else x > lo
        right = x <= hi if hi_inc else x < hi
        out |= left & right
    return out


def _rows(table: Table) -> int:
    return len(next(iter(table.values()))) if table else 0


def _take(table: Table, sel) -> Table:
    return {k: v[sel] for k, v in table.items()}


def _isin(col: np.ndarray, values) -> np.ndarray:
    values = set(values)
    return np.fromiter((v in values for v in col), dtype=bool, count=len(col))


def _missing(col: np.ndarray) -> np.ndarray:
    """pandas' `isna` of a column as loaded."""
    if col.dtype == object:
        return np.fromiter((v is None for v in col), dtype=bool, count=len(col))
    return np.isnan(col) if col.dtype.kind == "f" else np.zeros(len(col), bool)


def _factorize(tokens) -> tuple:
    """(codes int64, uniques) in first-appearance order (`pd.factorize`)."""
    lookup: Dict[str, int] = {}
    codes = np.fromiter((lookup.setdefault(t, len(lookup)) for t in tokens),
                        dtype=np.int64)
    return codes, list(lookup)


def _as_token(v) -> str:
    return "nan" if v is None else str(v)


def _concat(tables: List[Table], field2type: Dict[str, FeatureType]) -> Table:
    """Row-wise concatenation; a column a table lacks is missing there."""
    names: List[str] = []
    for t in tables:
        names += [k for k in t if k not in names]
    out: Table = {}
    for k in names:
        parts = []
        for t in tables:
            if k in t:
                parts.append(t[k])
                continue
            n, ft = _rows(t), field2type[k]
            if ft == FeatureType.FLOAT:
                parts.append(np.full(n, np.nan))
            else:
                parts.append(np.full(n, None, dtype=object))
        out[k] = np.concatenate(parts) if parts else np.zeros(0)
    return out


class Dataset:
    """Transductive dataset (the training corpus)."""

    def __init__(self, config):
        self.config = config
        self.dataset_name: str = config["dataset"]

        self.uid_field: str = config["USER_ID_FIELD"]
        self.iid_field: str = config["ITEM_ID_FIELD"]
        self.label_field: str = config["LABEL_FIELD"]
        self.time_field: str = config["TIME_FIELD"]

        self.field2type: Dict[str, FeatureType] = {}
        self.field2source: Dict[str, FeatureSource] = {}
        self.field2seqlen: Dict[str, int] = {}
        self.field2id_token: Dict[str, np.ndarray] = {}
        self.field2token_id: Dict[str, Dict[str, int]] = {}
        self.field2bucketnum: Dict[str, int] = {}

        self.inter_feat: Optional[Table] = None
        self.user_feat: Optional[Table] = None
        self.item_feat: Optional[Table] = None
        self.benchmark_filename_list = config["benchmark_filename"]
        self.file_size_list: List[int] = []

        self._load_data()
        self._data_processing()

    # ------------------------------------------------------------------ load

    def _data_processing(self) -> None:
        self._data_filtering()
        self._remap_id_all()
        self._remove_new_samples()
        self._user_item_feat_preparation()
        self._fill_nan()
        self._set_label_by_threshold()
        self._normalize()
        self._discretization()

    def _dataset_path(self) -> str:
        return os.path.join(self.config["data_path"], self.dataset_name)

    def _load_data(self) -> None:
        path = self._dataset_path()
        token = self.dataset_name
        sep = self.config["field_separator"]
        seq_sep = self.config["seq_separator"]
        load_col_cfg = self.config["load_col"]
        unload_col_cfg = self.config["unload_col"] or {}

        def cols_for(suffix: str):
            if load_col_cfg is None:
                return None, set(unload_col_cfg.get(suffix, []) or [])
            if suffix in load_col_cfg:
                lc = load_col_cfg[suffix]
                load = None if lc == "*" else set(lc)
            else:
                load = set()
            if load:
                # the fork force-loads the is_new split flag whenever a
                # column selection is given
                load.add("is_new")
            return load, set(unload_col_cfg.get(suffix, []) or [])

        inter_load, inter_unload = cols_for("inter")
        if self.benchmark_filename_list is None:
            fp = os.path.join(path, f"{token}.inter")
            if not os.path.isfile(fp):
                raise ValueError(f"File {fp} not exist.")
            self.inter_feat, f2t = load_atomic_file(fp, sep, seq_sep, inter_load, inter_unload)
            self._register_fields(f2t, FeatureSource.INTERACTION)
        else:
            feats, sizes = [], []
            for name in self.benchmark_filename_list:
                fp = os.path.join(path, f"{token}.{name}.inter")
                if not os.path.isfile(fp):
                    raise ValueError(f"File {fp} not exist.")
                t, f2t = load_atomic_file(fp, sep, seq_sep, inter_load, inter_unload)
                self._register_fields(f2t, FeatureSource.INTERACTION)
                feats.append(t)
                sizes.append(_rows(t))
            self.inter_feat = _concat(feats, self.field2type)
            self.file_size_list = sizes

        for suffix, source, id_field in (
            ("user", FeatureSource.USER, self.uid_field),
            ("item", FeatureSource.ITEM, self.iid_field),
        ):
            fp = os.path.join(path, f"{token}.{suffix}")
            load, unload = cols_for(suffix)
            if os.path.isfile(fp) and (load is None or load):
                t, f2t = load_atomic_file(fp, sep, seq_sep, load, unload)
                if not t or _rows(t) == 0:
                    continue
                if id_field not in t:
                    raise ValueError(
                        f"{id_field} must be loaded if {suffix} features are loaded."
                    )
                self._register_fields(f2t, source)
                self.field2source[id_field] = (
                    FeatureSource.USER_ID if suffix == "user" else FeatureSource.ITEM_ID
                )
                setattr(self, f"{suffix}_feat", t)

        # the side tables of `additional_feat_suffix`, kept raw (not
        # remapped) for `get_preload_weight`
        self.additional_feats: Dict[str, Table] = {}
        for suffix in self.config["additional_feat_suffix"] or []:
            fp = os.path.join(path, f"{token}.{suffix}")
            if os.path.isfile(fp):
                self.additional_feats[suffix], _ = load_atomic_file(fp, sep, seq_sep, None,
                                                                    set())

        if self.uid_field and self.uid_field not in self.field2type:
            self.field2type[self.uid_field] = FeatureType.TOKEN
        if self.iid_field and self.iid_field not in self.field2type:
            self.field2type[self.iid_field] = FeatureType.TOKEN

    def _register_fields(self, f2t: Dict[str, FeatureType], source) -> None:
        for field, ftype in f2t.items():
            self.field2source.setdefault(field, source)
            self.field2type[field] = ftype
            if not ftype.value.endswith("seq"):
                self.field2seqlen[field] = 1
            if "float" in ftype.value:
                self.field2bucketnum.setdefault(field, 2)

    # -------------------------------------------------------------- filtering

    def _data_filtering(self) -> None:
        """Missing-id drop, dedup, value filter, feature-row filter, k-core."""
        inter = self.inter_feat
        for f in (self.uid_field, self.iid_field):
            if f in inter:
                inter = _take(inter, ~_missing(inter[f]))

        rm_dup = self.config["rm_dup_inter"]
        if rm_dup in ("first", "last"):
            pairs = list(zip(inter[self.uid_field], inter[self.iid_field]))
            order = range(len(pairs)) if rm_dup == "first" else range(len(pairs) - 1, -1, -1)
            seen, keep = set(), np.zeros(len(pairs), bool)
            for i in order:
                if pairs[i] not in seen:
                    seen.add(pairs[i])
                    keep[i] = True
            inter = _take(inter, keep)

        val_interval = self.config["val_interval"]
        if val_interval:
            for field, iv_s in val_interval.items():
                iv = _parse_interval(iv_s)
                if field in inter:
                    inter = _take(inter, _in_interval(inter[field], iv))
                for name in ("user_feat", "item_feat"):
                    feat = getattr(self, name)
                    if feat is not None and field in feat:
                        setattr(self, name, _take(feat, _in_interval(feat[field], iv)))

        if self.config["filter_inter_by_user_or_item"]:
            if self.user_feat is not None:
                inter = _take(inter, _isin(inter[self.uid_field], self.user_feat[self.uid_field]))
            if self.item_feat is not None:
                inter = _take(inter, _isin(inter[self.iid_field], self.item_feat[self.iid_field]))

        u_iv = _parse_interval(self.config["user_inter_num_interval"])
        i_iv = _parse_interval(self.config["item_inter_num_interval"])
        if self.uid_field in inter and self.iid_field in inter and (u_iv or i_iv):
            def banned(field, feat, iv):
                if not iv:
                    return set()
                counts = Counter(inter[field])
                ids = list(counts)
                n = np.array([counts[i] for i in ids], dtype=np.float64)
                out = {i for i, ok in zip(ids, _in_interval(n, iv)) if not ok}
                if feat is not None and field in feat:
                    zero = set(feat[field]) - set(counts)
                    if zero and not _in_interval(np.zeros(1), iv)[0]:
                        out |= zero
                return out

            while True:
                ban_u = banned(self.uid_field, self.user_feat, u_iv)
                ban_i = banned(self.iid_field, self.item_feat, i_iv)
                if not ban_u and not ban_i:
                    break
                if self.user_feat is not None and ban_u:
                    self.user_feat = _take(
                        self.user_feat, ~_isin(self.user_feat[self.uid_field], ban_u))
                if self.item_feat is not None and ban_i:
                    self.item_feat = _take(
                        self.item_feat, ~_isin(self.item_feat[self.iid_field], ban_i))
                inter = _take(inter, ~_isin(inter[self.uid_field], ban_u)
                              & ~_isin(inter[self.iid_field], ban_i))

        self.inter_feat = inter

    # ---------------------------------------------------------------- remap

    def _alias_groups(self) -> "OrderedDict[str, np.ndarray]":
        alias = OrderedDict()
        alias[self.uid_field] = np.array(
            [self.uid_field] + list(self.config["alias_of_user_id"] or []))
        alias[self.iid_field] = np.array(
            [self.iid_field] + list(self.config["alias_of_item_id"] or []))
        return alias

    def _field_feats(self, field: str) -> List[Table]:
        """Tables holding `field`, interaction first."""
        return [t for t in (self.inter_feat, self.user_feat, self.item_feat)
                if t is not None and field in t]

    def _remap_id_all(self) -> None:
        remapped = set()
        for fields in self._alias_groups().values():
            fields = [f for f in fields if f in self.field2type]
            self._remap_fields(fields)
            remapped.update(fields)
        rest = [
            f for f, t in self.field2type.items()
            if t in (FeatureType.TOKEN, FeatureType.TOKEN_SEQ) and f not in remapped
        ]
        for f in rest:
            self._remap_fields([f])

    def _remap_fields(self, fields: List[str]) -> None:
        """First-appearance remap over the fields' columns in table order,
        with [PAD] = 0: each chunk factorizes on its own, and merging the
        chunk vocabularies in order equals one factorize over the stream."""
        remap_list = []
        for field in fields:
            ftype = self.field2type[field]
            for feat in self._field_feats(field):
                remap_list.append((feat, field, ftype))
        if not remap_list:
            return

        pairs = []
        for feat, field, ftype in remap_list:
            if ftype == FeatureType.TOKEN:
                tokens = (_as_token(v) for v in feat[field])
            else:
                tokens = (str(t) for cell in feat[field] for t in cell)
            pairs.append(_factorize(tokens))

        lookup: Dict[str, int] = {}
        merged: List[str] = []
        new_ids_list = []
        for codes, uniq in pairs:
            remap = np.empty(len(uniq), np.int64)
            for j, t in enumerate(uniq):
                g = lookup.get(t)
                if g is None:
                    g = len(merged)
                    lookup[t] = g
                    merged.append(t)
                remap[j] = g
            new_ids_list.append((remap[codes] if len(uniq) else codes) + 1)
        mp = np.array(["[PAD]"] + merged)
        token_id = {t: i for i, t in enumerate(mp)}

        for (feat, field, ftype), ids in zip(remap_list, new_ids_list):
            if field not in self.field2id_token:
                self.field2id_token[field] = mp
                self.field2token_id[field] = token_id
            if ftype == FeatureType.TOKEN:
                feat[field] = ids
            else:
                sp = np.cumsum([len(v) for v in feat[field]])[:-1]
                col = np.empty(len(feat[field]), dtype=object)
                col[:] = np.split(ids, sp) if len(col) else []
                feat[field] = col

    def _remove_new_samples(self) -> None:
        """Drop is_new == '1' rows (transductive corpus only)."""
        if self.inter_feat is None or "is_new" not in self.inter_feat:
            return
        new_id = self.field2token_id["is_new"].get("1")
        if new_id is None:
            return
        self.inter_feat = _take(self.inter_feat, self.inter_feat["is_new"] != new_id)

    # ------------------------------------------------------- feat preparation

    def _reindex(self, feat: Table, id_field: str, n: int) -> Table:
        """Row i holds id i (a left merge on arange(n)); ids without a row
        get a missing one: NaN in token and float columns, None in
        sequence columns, as pandas leaves them for `_fill_nan`."""
        ids = np.asarray(feat[id_field], np.int64)
        if len(np.unique(ids)) != len(ids):
            raise ValueError(f"{id_field} has duplicate rows in its feature file")
        pos = np.full(n, -1, np.int64)
        pos[ids] = np.arange(len(ids))
        have = pos >= 0
        out: Table = {id_field: np.arange(n, dtype=np.int64)}
        for k, v in feat.items():
            if k == id_field:
                continue
            if v.dtype == object:
                col = np.full(n, None, dtype=object)
            else:
                col = np.full(n, np.nan)
            col[have] = v[pos[have]]
            out[k] = col
        return out

    def _user_item_feat_preparation(self) -> None:
        if self.user_feat is not None:
            self.user_feat = self._reindex(self.user_feat, self.uid_field, self.user_num)
        if self.item_feat is not None:
            self.item_feat = self._reindex(self.item_feat, self.iid_field, self.item_num)

    def _fill_nan(self) -> None:
        """Token ids fall back to PAD (0), scalar floats to the column mean
        (pandas' mean: NaN as 0 in the sum, over the count of values),
        sequence cells to an empty array of the field's dtype."""
        seq_dtypes = {FeatureType.TOKEN_SEQ: np.int64, FeatureType.FLOAT_SEQ: np.float64}
        for feat in self._feats():
            for field in list(feat):
                ftype = self.field2type[field]
                column = feat[field]
                if ftype == FeatureType.TOKEN:
                    if column.dtype.kind == "f":
                        column = np.where(np.isnan(column), 0, column)
                    feat[field] = column.astype(np.int64)
                elif ftype == FeatureType.FLOAT:
                    nan = np.isnan(column)
                    if nan.any():
                        count = len(column) - int(nan.sum())
                        mean = (np.where(nan, 0.0, column).sum(dtype=np.float64) / np.float64(count)
                                if count else np.nan)
                        column = np.where(nan, mean, column)
                    feat[field] = column
                else:
                    empty = np.array([], dtype=seq_dtypes[ftype])
                    col = np.empty(len(column), dtype=object)
                    col[:] = [c if isinstance(c, np.ndarray) else empty for c in column]
                    feat[field] = col

    def _set_label_by_threshold(self) -> None:
        """Binarize one rating-like column into the label field."""
        spec = self.config["threshold"]
        if not spec:
            return
        if len(spec) != 1:
            raise ValueError(f"threshold must name exactly one field, got {sorted(spec)}")
        ((src_field, cutoff),) = spec.items()
        if src_field not in self.inter_feat:
            raise ValueError(f"threshold field [{src_field}] absent from inter_feat")
        self.field2type[self.label_field] = FeatureType.FLOAT
        self.field2source[self.label_field] = FeatureSource.INTERACTION
        self.field2seqlen[self.label_field] = 1
        labels = np.asarray(self.inter_feat[src_field]) >= cutoff
        self.inter_feat[self.label_field] = labels.astype(np.int64)
        if src_field != self.label_field:
            del self.inter_feat[src_field]

    def _normalize(self) -> None:
        """Min-max scale float fields into [0, 1] (a constant column maps to
        ones); sequence fields over the pool of all their elements."""
        by_field = self.config["normalize_field"]
        all_floats = self.config["normalize_all"]
        if by_field and all_floats:
            raise ValueError("normalize_field and normalize_all are mutually exclusive")
        float_types = (FeatureType.FLOAT, FeatureType.FLOAT_SEQ)
        if by_field:
            fields = by_field
        elif all_floats:
            fields = [f for f, t in self.field2type.items() if t in float_types]
        else:
            return

        def minmax(values: np.ndarray) -> np.ndarray:
            lo, hi = values.min(), values.max()
            if hi == lo:
                return np.ones_like(values)
            return (values - lo) / (hi - lo)

        for field in fields:
            ftype = self.field2type.get(field)
            if ftype not in float_types:
                continue
            for feat in self._field_feats(field):
                if ftype == FeatureType.FLOAT:
                    feat[field] = minmax(np.asarray(feat[field], np.float64))
                else:
                    cells = list(feat[field])
                    lengths = [len(c) for c in cells]
                    if sum(lengths) == 0:
                        continue
                    scaled = minmax(np.concatenate(cells))
                    col = np.empty(len(cells), dtype=object)
                    col[:] = np.split(scaled, np.cumsum(lengths)[:-1])
                    feat[field] = col

    def _discretization(self) -> None:
        """Numerical features → (value, bucket) pairs: the value column
        `field` and an int64 companion column `field__bucket`:
          * ED: value 1, bucket floor((x−lo)·B/(hi−lo)+1), bucketnum max+1
          * LD: value 1, bucket the unique rank of floor(log(x)²+1) (x > 2)
          * not configured: value x, bucket 1, bucketnum 2
        """
        dis_info = dict(self.config["discretization"] or {})
        for field in self.config["numerical_features"] or []:
            if field not in self.field2type:
                continue
            if field in dis_info:
                info = dis_info[field]
                method = info["method"]
                bucket_cnt = info.get("bucket")
                if method == "ED" and bucket_cnt is None:
                    raise ValueError(
                        "The number of buckets must be set when apply equal discretization.")
                for feat in self._field_feats(field):
                    arr = np.asarray(feat[field], np.float64)
                    if method == "ED":
                        lower, upper = arr.min(), arr.max() + 1e-9
                        if upper != lower:
                            res = np.floor((arr - lower) * bucket_cnt / (upper - lower) + 1)
                        else:
                            res = np.ones_like(arr) * bucket_cnt
                    elif method == "LD":
                        mask = arr > 2
                        x = np.floor(np.log(arr * mask + 1e-9) ** 2 + 1)
                        x = np.where(mask, x, arr)
                        _, res = np.unique(x, return_inverse=True)
                    else:
                        raise ValueError(f"Method [{method}] does not exist.")
                    self.field2bucketnum[field] = int(res.max() + 1)
                    feat[field + "__bucket"] = res.astype(np.int64)
                    feat[field] = np.ones_like(arr)
            else:
                for feat in self._field_feats(field):
                    feat[field + "__bucket"] = np.ones(_rows(feat), np.int64)
                self.field2bucketnum.setdefault(field, 2)

    def _feats(self) -> List[Table]:
        return [f for f in (self.inter_feat, self.user_feat, self.item_feat) if f is not None]

    # ---------------------------------------------------------------- counts

    @property
    def user_num(self) -> int:
        return len(self.field2id_token[self.uid_field])

    @property
    def item_num(self) -> int:
        return len(self.field2id_token[self.iid_field])

    def token2id(self, field: str, tokens):
        """The internal id of a token (a str), or an array of ids."""
        t2i = self.field2token_id[field]
        if isinstance(tokens, str):
            return t2i[tokens]
        return np.array([t2i[t] for t in tokens])

    def id2token(self, field: str, ids):
        """The tokens of internal ids."""
        return self.field2id_token[field][ids]

    def get_preload_weight(self, kid: str) -> np.ndarray:
        """The float32 matrix of `preload_weight: {kid: vector field}` from
        an `additional_feat_suffix` table holding both columns. Its rows
        follow the entity, item or user vocabulary (in that order of
        trial) whose tokens cover at least half the table's, row 0 and the
        vocabulary's absent tokens zero; else the table's order after a
        zero pad row."""
        pw = self.config["preload_weight"] or {}
        if kid not in pw:
            raise ValueError(f"Field [{kid}] not in preload_weight config.")
        vfield = pw[kid]
        table = next((t for t in self.additional_feats.values()
                      if kid in t and vfield in t), None)
        if table is None:
            raise ValueError(f"No additional feat file holds [{kid}] and [{vfield}].")
        tokens = [_as_token(t) for t in table[kid]]
        vecs = np.stack([np.asarray(v, np.float32) for v in table[vfield]])
        for vocab_field in (getattr(self, "entity_field", None), self.iid_field,
                            self.uid_field):
            if vocab_field and vocab_field in self.field2token_id:
                t2i = self.field2token_id[vocab_field]
                if sum(t in t2i for t in tokens) >= 0.5 * len(tokens):
                    out = np.zeros((len(self.field2id_token[vocab_field]), vecs.shape[1]),
                                   np.float32)
                    for t, v in zip(tokens, vecs):
                        if t in t2i:
                            out[t2i[t]] = v
                    return out
        out = np.zeros((len(tokens) + 1, vecs.shape[1]), np.float32)
        out[1:] = vecs
        return out

    def num(self, field: str) -> int:
        ftype = self.field2type.get(field)
        if ftype is None:
            raise ValueError(f"Field [{field}] not defined in dataset.")
        if ftype in (FeatureType.FLOAT, FeatureType.FLOAT_SEQ) and field in (
            self.config["numerical_features"] or []
        ):
            return self.field2bucketnum[field]
        if ftype not in (FeatureType.TOKEN, FeatureType.TOKEN_SEQ):
            return self.field2seqlen[field]
        return len(self.field2id_token[field])

    def __len__(self) -> int:
        return 0 if self.inter_feat is None else _rows(self.inter_feat)

    # ---------------------------------------------------------------- build

    def build(self) -> List["DatasetSplit"]:
        """Group/order/split into [train, valid, test] index views."""
        if self.benchmark_filename_list is not None:
            cumsum = list(np.cumsum(self.file_size_list))
            return [self._make_split(np.arange(start, end))
                    for start, end in zip([0] + cumsum[:-1], cumsum)]

        order = self.config["eval_args"]["order"]
        n = len(self)
        index = np.arange(n)
        if order == "RO":
            rng = host_rng(self.config["seed"] or 0, "dataset_shuffle")
            rng.shuffle(index)
        elif order == "TO":
            # the fork's TO sort is commented out: splits use file order
            pass
        else:
            raise NotImplementedError(f"The ordering_method [{order}] has not been implemented.")

        split_args = self.config["eval_args"]["split"]
        mode = list(split_args.keys())[0]
        group_by = self.config["eval_args"]["group_by"]
        if mode == "RS":
            ratios = split_args["RS"]
            tot = sum(ratios)
            ratios = [r / tot for r in ratios]
            if group_by is None or str(group_by).lower() == "none":
                split_ids = _calcu_split_ids(n, ratios)
                parts = [index[start:end]
                         for start, end in zip([0] + split_ids, split_ids + [n])]
            elif group_by == "user":
                uid = self.inter_feat[self.uid_field][index]
                chunks: List[List[np.ndarray]] = [[] for _ in ratios]
                cuts: Dict[int, List[int]] = {}
                for grouped in _grouped_index(uid):
                    grouped = index[grouped]
                    m = len(grouped)
                    if m not in cuts:
                        cuts[m] = _calcu_split_ids(m, ratios)
                    for part, start, end in zip(chunks, [0] + cuts[m], cuts[m] + [m]):
                        part.append(grouped[start:end])
                parts = [np.concatenate(p).astype(np.int64) if p else np.zeros(0, np.int64)
                         for p in chunks]
            else:
                raise NotImplementedError(
                    f"The grouping method [{group_by}] has not been implemented.")
        elif mode == "LS":
            parts = self._leave_one_out(index, split_args["LS"])
        else:
            raise NotImplementedError(f"The splitting_method [{mode}] has not been implemented.")
        return [self._make_split(p) for p in parts]

    def _leave_one_out(self, index: np.ndarray, leave_one_mode: str):
        uid = self.inter_feat[self.uid_field][index]
        leave_one_num = 2 if leave_one_mode == "valid_and_test" else 1
        next_index: List[list] = [[] for _ in range(leave_one_num + 1)]
        for g in _grouped_index(uid):
            g = list(index[g])
            tot = len(g)
            legal = min(leave_one_num, tot - 1)
            pr = tot - legal
            next_index[0].extend(g[:pr])
            for i in range(legal):
                next_index[-legal + i].append(g[pr])
                pr += 1
        if leave_one_mode == "valid_and_test":
            parts = next_index
        elif leave_one_mode == "valid_only":
            parts = [next_index[0], next_index[1], []]
        elif leave_one_mode == "test_only":
            parts = [next_index[0], [], next_index[1]]
        else:
            raise NotImplementedError(
                f"The leave_one_mode [{leave_one_mode}] has not been implemented.")
        return [np.array(p, dtype=np.int64) for p in parts]

    def _make_split(self, index: np.ndarray) -> "DatasetSplit":
        return DatasetSplit.view(self, index)

    # ------------------------------------------------------------- exports

    def __repr__(self) -> str:
        n_u, n_i, n = self.user_num - 1, self.item_num - 1, len(self)
        sparsity = 100 * (1 - n / max(n_u * n_i, 1))
        return (
            f"{self.dataset_name}\n"
            f"The number of users: {self.user_num}\n"
            f"Average actions of users: {n / max(n_u, 1):.4f}\n"
            f"The number of items: {self.item_num}\n"
            f"Average actions of items: {n / max(n_i, 1):.4f}\n"
            f"The number of inters: {n}\n"
            f"The sparsity of the dataset: {sparsity:.6f}%"
        )

    def get_user_feature(self) -> Dict[str, np.ndarray]:
        """Dense per-user feature arrays keyed by field (row i = user i)."""
        if self.user_feat is None:
            return {self.uid_field: np.arange(self.user_num)}
        return _table_to_arrays(self.user_feat, self.field2type)

    def get_item_feature(self) -> Dict[str, np.ndarray]:
        if self.item_feat is None:
            return {self.iid_field: np.arange(self.item_num)}
        return _table_to_arrays(self.item_feat, self.field2type)

    def history_item_matrix(self, max_history_len: Optional[int] = None):
        """(history (n_users, H), lengths (n_users,)): each user's items in
        row order, padded with 0 and cut at H."""
        uid = np.asarray(self.inter_feat[self.uid_field], np.int64)
        iid = np.asarray(self.inter_feat[self.iid_field], np.int64)
        counts = np.bincount(uid, minlength=self.user_num)
        H = max_history_len or (int(counts.max()) if len(counts) else 1)
        order = np.argsort(uid, kind="stable")
        su = uid[order]
        rank = np.arange(len(su)) - np.searchsorted(su, su, side="left")
        keep = rank < H
        out = np.zeros((self.user_num, H), dtype=np.int64)
        out[su[keep], rank[keep]] = iid[order][keep]
        lens = np.minimum(counts, H).astype(np.int64)
        return out, lens


class DatasetSplit:
    """One phase's interaction rows: field name → (n,) array.

    Built from arrays (`DatasetSplit(inter, user_num, item_num, ...)`, the
    form every array-made pipeline uses) or as a view over a parent
    `Dataset` (`DatasetSplit.view(parent, index)`), which takes the rows at
    `index` and the parent's counts, field names and feature tables."""

    def __init__(
        self,
        inter: Dict[str, np.ndarray],
        user_num: int,
        item_num: int,
        uid_field: str = "user_id",
        iid_field: str = "item_id",
        label_field: str = "label",
        user_feat: Optional[Dict[str, np.ndarray]] = None,
        item_feat: Optional[Dict[str, np.ndarray]] = None,
    ):
        self.inter = {k: np.asarray(v) for k, v in inter.items()}
        self.user_feat = _as_arrays(user_feat)
        self.item_feat = _as_arrays(item_feat)
        self.user_num = int(user_num)
        self.item_num = int(item_num)
        self.uid_field = uid_field
        self.iid_field = iid_field
        self.label_field = label_field
        self.parent: Optional[Dataset] = None
        self.index: Optional[np.ndarray] = None

    @classmethod
    def view(cls, parent: Dataset, index: np.ndarray) -> "DatasetSplit":
        index = np.asarray(index, dtype=np.int64)
        split = cls(
            _table_to_arrays(_take(parent.inter_feat, index), parent.field2type),
            parent.user_num, parent.item_num,
            uid_field=parent.uid_field, iid_field=parent.iid_field,
            label_field=parent.label_field,
            user_feat=parent.get_user_feature() if parent.user_feat is not None else None,
            item_feat=parent.get_item_feature() if parent.item_feat is not None else None,
        )
        split.parent, split.index = parent, index
        return split

    def __len__(self) -> int:
        return len(self.inter[self.uid_field])

    def used_ids_per_user(self) -> List[np.ndarray]:
        """Per-user arrays of interacted item ids within this split."""
        uid = self.inter[self.uid_field]
        iid = self.inter[self.iid_field]
        order = np.argsort(uid, kind="stable")
        out: List[np.ndarray] = [np.array([], dtype=np.int64)] * self.user_num
        if len(uid) == 0:
            return out
        su, si = uid[order], iid[order]
        bounds = np.flatnonzero(np.diff(su)) + 1
        starts = np.concatenate([[0], bounds])
        ends = np.concatenate([bounds, [len(su)]])
        for s, e in zip(starts, ends):
            out[su[s]] = si[s:e]
        return out


def _as_arrays(feat: Optional[Dict[str, np.ndarray]]):
    return None if feat is None else {k: np.asarray(v) for k, v in feat.items()}


def _table_to_arrays(table: Table, field2type: Dict[str, FeatureType]) -> Dict[str, np.ndarray]:
    """Table → arrays: tokens int64, floats float32, sequences padded to
    their longest row with a `<field>_len` column."""
    out: Dict[str, np.ndarray] = {}
    for col, v in table.items():
        if col.endswith("__bucket"):
            out[col] = np.asarray(v).astype(np.int64)
            continue
        ftype = field2type.get(col, FeatureType.FLOAT)
        if ftype == FeatureType.TOKEN:
            out[col] = np.asarray(v).astype(np.int64)
        elif ftype == FeatureType.FLOAT:
            out[col] = np.asarray(v).astype(np.float32)
        else:
            vals = list(v)
            maxlen = max((len(c) for c in vals), default=0)
            dtype = np.int64 if ftype == FeatureType.TOKEN_SEQ else np.float32
            arr = np.zeros((len(vals), maxlen), dtype=dtype)
            for i, c in enumerate(vals):
                arr[i, : len(c)] = c
            out[col] = arr
            out[col + "_len"] = np.array([len(c) for c in vals], dtype=np.int64)
    return out


def _grouped_index(group_by_list: np.ndarray) -> List[np.ndarray]:
    """Per-key index arrays, keys in first-appearance order, each key's
    indices ascending."""
    keys = np.asarray(group_by_list)
    if len(keys) == 0:
        return []
    _, first, inverse = np.unique(keys, return_index=True, return_inverse=True)
    rank = np.empty(len(first), np.int64)
    rank[np.argsort(first, kind="stable")] = np.arange(len(first))
    g = rank[inverse.ravel()]
    order = np.argsort(g, kind="stable")
    bounds = np.flatnonzero(np.diff(g[order])) + 1
    return np.split(order, bounds)


def _calcu_split_ids(tot: int, ratios: List[float]) -> List[int]:
    """The reference's exact rounding (`dataset.py:1623-1645`)."""
    cnt = [int(ratios[i] * tot) for i in range(len(ratios))]
    cnt[0] = tot - sum(cnt[1:])
    for i in range(1, len(ratios)):
        if cnt[0] <= 1:
            break
        if 0 < ratios[-i] * tot < 1:
            cnt[-i] += 1
            cnt[0] -= 1
    return [int(c) for c in np.cumsum(cnt)[:-1]]
