"""Data preprocessors: stateful fit/transform over Datasets (port of
ray_tpu/data/preprocessors.py).

Counterpart of the reference's ``ray.data.preprocessors`` package
(reference: python/ray/data/preprocessor.py:28 Preprocessor ABC +
preprocessors/{scaler,encoder,imputer,chain,concatenator,normalizer,
discretizer}.py). Rebuilt numpy-first: fitting runs through the
Dataset's columnar aggregates, transforms are plain batch functions
applied via ``map_batches`` — the shape a training pipeline feeds
from. Fitted state serializes with the object (cloudpickle), so a
preprocessor fit on a driver travels to Train workers."""

from __future__ import annotations

from typing import Any

import numpy as np


class PreprocessorNotFittedException(RuntimeError):
    """Transform requested before fit (reference: preprocessor.py:21)."""


def _as_column(values) -> np.ndarray:
    """1-D column array. List-valued cells (e.g. genre lists) become a
    1-D OBJECT array of lists — a bare np.asarray would collapse
    equal-width lists into 2-D (breaking cross-block concatenation the
    moment widths differ) and reject ragged ones outright."""
    if isinstance(values, np.ndarray) and values.ndim == 1 \
            and values.dtype != object:
        return values
    vals = list(values) if not isinstance(values, np.ndarray) \
        else values.tolist()
    if any(isinstance(x, (list, tuple, np.ndarray)) for x in vals):
        col = np.empty(len(vals), dtype=object)
        for i, x in enumerate(vals):
            col[i] = x
        return col
    return np.asarray(vals)


def _fit_columns(dataset, columns: list) -> dict:
    """All requested columns in ONE plan execution (per-column
    Dataset._column_values calls would re-run the whole upstream plan
    once per column — O(columns x dataset) fit cost)."""
    parts: dict = {c: [] for c in columns}
    from ray_tpu_torch.data.block import BlockAccessor

    for block in dataset.iter_blocks():
        batch = BlockAccessor(block).to_numpy()
        for c in columns:
            parts[c].append(_as_column(batch[c]))
    return {c: (np.concatenate(v) if v else np.array([]))
            for c, v in parts.items()}


class Preprocessor:
    """fit/transform over Datasets + transform_batch for serving-time
    single batches (reference: Preprocessor ABC, preprocessor.py:28).

    Subclasses override ``_fit(dataset)`` (stateful; set
    ``_is_fittable = False`` for stateless transforms) and
    ``_transform_batch(batch) -> batch``."""

    _is_fittable = True

    def __init__(self):
        self._fitted = False

    # -- lifecycle ---------------------------------------------------------

    def fit(self, dataset) -> "Preprocessor":
        if self._is_fittable:
            self._fit(dataset)
        self._fitted = True
        return self

    def fit_transform(self, dataset):
        return self.fit(dataset).transform(dataset)

    def transform(self, dataset):
        self._check_fitted()
        return dataset.map_batches(self._transform_batch)

    def transform_batch(self, batch: dict) -> dict:
        """One in-memory columnar batch (serving-time path). List-
        valued columns (ragged or uniform) coerce to 1-D object
        arrays — the input shape MultiHotEncoder/FeatureHasher
        document."""
        self._check_fitted()
        return self._transform_batch({k: _as_column(v)
                                      for k, v in batch.items()})

    def _check_fitted(self) -> None:
        if self._is_fittable and not self._fitted:
            raise PreprocessorNotFittedException(
                f"{type(self).__name__} must be fit before transform")

    # -- overrides ---------------------------------------------------------

    def _fit(self, dataset) -> None:
        raise NotImplementedError

    def _transform_batch(self, batch: dict) -> dict:
        raise NotImplementedError


class Chain(Preprocessor):
    """Sequential composition; fit stage i on the output of stages <i
    (reference: preprocessors/chain.py)."""

    def __init__(self, *preprocessors: Preprocessor):
        super().__init__()
        self.preprocessors = list(preprocessors)
        # A chain of stateless members is itself stateless (the
        # reference derives Chain's fittable state from its members):
        # a serving path must not need a meaningless fit() call.
        self._is_fittable = any(p._is_fittable for p in self.preprocessors)

    def _fit(self, dataset) -> None:
        for p in self.preprocessors:
            dataset = p.fit(dataset).transform(dataset)

    def transform(self, dataset):
        self._check_fitted()
        for p in self.preprocessors:
            dataset = p.transform(dataset)
        return dataset

    def transform_batch(self, batch: dict) -> dict:
        self._check_fitted()
        for p in self.preprocessors:
            batch = p.transform_batch(batch)
        return batch


class StandardScaler(Preprocessor):
    """(x - mean) / std per column (reference: scaler.py StandardScaler).
    Zero-variance columns scale to 0 (the reference's behavior)."""

    def __init__(self, columns: list[str]):
        super().__init__()
        self.columns = list(columns)
        self.stats_: dict[str, tuple] = {}

    def _fit(self, dataset) -> None:
        # One plan execution for every column; nan-aware like the
        # reference's null-skipping aggregates (a single NaN must not
        # poison the stats into zeroing the column).
        cols = _fit_columns(dataset, self.columns)
        for c in self.columns:
            vals = cols[c].astype(np.float64)
            self.stats_[c] = (float(np.nanmean(vals)),
                              float(np.nanstd(vals)))

    def _transform_batch(self, batch: dict) -> dict:
        out = dict(batch)
        for c in self.columns:
            mean, std = self.stats_[c]
            v = np.asarray(batch[c], dtype=np.float64)
            out[c] = (v - mean) / std if std > 0 else np.zeros_like(v)
        return out


class MinMaxScaler(Preprocessor):
    """(x - min) / (max - min) per column (reference: scaler.py
    MinMaxScaler)."""

    def __init__(self, columns: list[str]):
        super().__init__()
        self.columns = list(columns)
        self.stats_: dict[str, tuple] = {}

    def _fit(self, dataset) -> None:
        cols = _fit_columns(dataset, self.columns)
        for c in self.columns:
            vals = cols[c].astype(np.float64)
            self.stats_[c] = (float(np.nanmin(vals)),
                              float(np.nanmax(vals)))

    def _transform_batch(self, batch: dict) -> dict:
        out = dict(batch)
        for c in self.columns:
            lo, hi = self.stats_[c]
            v = np.asarray(batch[c], dtype=np.float64)
            span = hi - lo
            out[c] = (v - lo) / span if span > 0 else np.zeros_like(v)
        return out


class RobustScaler(Preprocessor):
    """(x - median) / IQR per column (reference: scaler.py
    RobustScaler; quantile_range as fractions)."""

    def __init__(self, columns: list[str],
                 quantile_range: tuple = (0.25, 0.75)):
        super().__init__()
        self.columns = list(columns)
        self.quantile_range = quantile_range
        self.stats_: dict[str, tuple] = {}

    def _fit(self, dataset) -> None:
        lo_q, hi_q = self.quantile_range
        cols = _fit_columns(dataset, self.columns)
        for c in self.columns:
            vals = cols[c].astype(np.float64)
            med = float(np.nanmedian(vals))
            iqr = float(np.nanquantile(vals, hi_q)
                        - np.nanquantile(vals, lo_q))
            self.stats_[c] = (med, iqr)

    def _transform_batch(self, batch: dict) -> dict:
        out = dict(batch)
        for c in self.columns:
            med, iqr = self.stats_[c]
            v = np.asarray(batch[c], dtype=np.float64)
            out[c] = (v - med) / iqr if iqr > 0 else np.zeros_like(v)
        return out


def _encode_sorted(values: np.ndarray, cats: np.ndarray,
                   column: str) -> np.ndarray:
    """Vectorized codes against a SORTED category array (the hot
    map_batches path must not run per-element dict lookups): position
    via searchsorted, then one equality sweep flags unseen values."""
    idx = np.searchsorted(cats, values)
    idx_c = np.clip(idx, 0, len(cats) - 1)
    bad = cats[idx_c] != values
    if bad.any():
        raise ValueError(
            f"unseen value {values[bad][0]!r} in {column!r}")
    return idx_c.astype(np.int64)


class LabelEncoder(Preprocessor):
    """Categorical column -> dense int codes, sorted-unique order
    (reference: encoder.py LabelEncoder). Unseen values raise."""

    def __init__(self, label_column: str):
        super().__init__()
        self.label_column = label_column
        self.stats_: Any = None  # sorted category array

    def _fit(self, dataset) -> None:
        vals = _fit_columns(dataset, [self.label_column])[self.label_column]
        self.stats_ = np.unique(vals)  # sorted

    def _transform_batch(self, batch: dict) -> dict:
        out = dict(batch)
        out[self.label_column] = _encode_sorted(
            np.asarray(batch[self.label_column]), self.stats_,
            self.label_column)
        return out

    def inverse_transform_batch(self, batch: dict) -> dict:
        out = dict(batch)
        out[self.label_column] = self.stats_[
            np.asarray(batch[self.label_column], dtype=np.int64)]
        return out


class OrdinalEncoder(Preprocessor):
    """Like LabelEncoder over several feature columns (reference:
    encoder.py OrdinalEncoder)."""

    def __init__(self, columns: list[str]):
        super().__init__()
        self.columns = list(columns)
        self.stats_: dict[str, np.ndarray] = {}

    def _fit(self, dataset) -> None:
        cols = _fit_columns(dataset, self.columns)
        for c in self.columns:
            self.stats_[c] = np.unique(cols[c])  # sorted

    def _transform_batch(self, batch: dict) -> dict:
        out = dict(batch)
        for c in self.columns:
            out[c] = _encode_sorted(np.asarray(batch[c]),
                                    self.stats_[c], c)
        return out


class OneHotEncoder(Preprocessor):
    """Column -> one indicator column per category, named
    ``{col}_{value}`` (reference: encoder.py OneHotEncoder). Unseen
    values encode as all-zeros."""

    def __init__(self, columns: list[str]):
        super().__init__()
        self.columns = list(columns)
        self.stats_: dict[str, list] = {}

    def _fit(self, dataset) -> None:
        cols = _fit_columns(dataset, self.columns)
        for c in self.columns:
            self.stats_[c] = sorted(np.unique(cols[c]).tolist())

    def _transform_batch(self, batch: dict) -> dict:
        out = dict(batch)
        for c in self.columns:
            vals = np.asarray(out.pop(c))
            for cat in self.stats_[c]:
                out[f"{c}_{cat}"] = (vals == cat).astype(np.int64)
        return out


def _missing_mask(arr: np.ndarray) -> np.ndarray:
    """Missing = NaN for float arrays; None-or-NaN elements for object
    arrays (categorical columns carry missing values as None)."""
    if arr.dtype.kind == "f":
        return np.isnan(arr)
    if arr.dtype == object:
        return np.asarray([
            x is None or (isinstance(x, float) and np.isnan(x))
            for x in arr.tolist()])
    return np.zeros(len(arr), dtype=bool)


class SimpleImputer(Preprocessor):
    """Fill missing values with mean/median/most_frequent/constant
    (reference: imputer.py SimpleImputer). mean/median are numeric;
    most_frequent and constant also handle categorical (object/str)
    columns — most_frequent's primary reference use case."""

    def __init__(self, columns: list[str], strategy: str = "mean",
                 fill_value: Any = None):
        super().__init__()
        if strategy not in ("mean", "median", "most_frequent", "constant"):
            raise ValueError(f"unknown strategy {strategy!r}")
        if strategy == "constant" and fill_value is None:
            raise ValueError("strategy='constant' requires fill_value")
        self.columns = list(columns)
        self.strategy = strategy
        self.fill_value = fill_value
        self.stats_: dict[str, Any] = {}
        self._is_fittable = strategy != "constant"

    def _fit(self, dataset) -> None:
        cols = _fit_columns(dataset, self.columns)
        for c in self.columns:
            vals = cols[c]
            if self.strategy == "most_frequent":
                ok = vals[~_missing_mask(vals)]
                uniq, counts = np.unique(ok, return_counts=True)
                self.stats_[c] = uniq[counts.argmax()]
                continue
            fvals = vals.astype(np.float64)
            ok = fvals[~np.isnan(fvals)]
            self.stats_[c] = (float(ok.mean()) if self.strategy == "mean"
                              else float(np.median(ok)))

    def _transform_batch(self, batch: dict) -> dict:
        out = dict(batch)
        for c in self.columns:
            fill = (self.fill_value if self.strategy == "constant"
                    else self.stats_[c])
            v = np.asarray(batch[c])
            if v.dtype.kind == "f" or (v.dtype != object
                                       and self.strategy in
                                       ("mean", "median")):
                v = v.astype(np.float64).copy()
                v[np.isnan(v)] = fill
            elif v.dtype == object:
                v = v.copy()
                v[_missing_mask(v)] = fill
            # else: integer/bool columns have no missing representation
            # — pass through untouched (converting to object would push
            # a clean numeric column off the device fast path).
            out[c] = v
        return out


class Concatenator(Preprocessor):
    """Merge feature columns into one 2-D ``output_column_name`` array —
    the model-input shape (reference: concatenator.py). Stateless."""

    _is_fittable = False

    def __init__(self, columns: list[str],
                 output_column_name: str = "concat_out",
                 dtype=np.float32, drop: bool = True):
        super().__init__()
        self.columns = list(columns)
        self.output_column_name = output_column_name
        self.dtype = dtype
        self.drop = drop

    def _transform_batch(self, batch: dict) -> dict:
        out = dict(batch)
        parts = []
        for c in self.columns:
            v = np.asarray(batch[c])
            # reshape(-1) cannot infer a width for 0-row blocks (a
            # zero-row parquet row-group reaches here via streaming);
            # derive the width from the trailing shape instead.
            width = int(np.prod(v.shape[1:])) if v.ndim > 1 else 1
            parts.append(v.reshape(len(v), width))
            if self.drop:
                out.pop(c, None)
        out[self.output_column_name] = np.concatenate(
            parts, axis=1).astype(self.dtype)
        return out


class Normalizer(Preprocessor):
    """Row-wise lp-normalization over feature columns (reference:
    normalizer.py). Stateless."""

    _is_fittable = False

    def __init__(self, columns: list[str], norm: str = "l2"):
        super().__init__()
        if norm not in ("l1", "l2", "max"):
            raise ValueError(f"unknown norm {norm!r}")
        self.columns = list(columns)
        self.norm = norm

    def _transform_batch(self, batch: dict) -> dict:
        out = dict(batch)
        mat = np.stack([np.asarray(batch[c], dtype=np.float64)
                        for c in self.columns], axis=1)
        if self.norm == "l1":
            d = np.abs(mat).sum(axis=1)
        elif self.norm == "l2":
            d = np.sqrt((mat * mat).sum(axis=1))
        else:
            d = np.abs(mat).max(axis=1)
        d[d == 0] = 1.0
        for i, c in enumerate(self.columns):
            out[c] = mat[:, i] / d
        return out


class UniformKBinsDiscretizer(Preprocessor):
    """Equal-width binning into int bin ids (reference:
    discretizer.py UniformKBinsDiscretizer)."""

    def __init__(self, columns: list[str], bins: int):
        super().__init__()
        self.columns = list(columns)
        self.bins = int(bins)
        self.stats_: dict[str, tuple] = {}

    def _fit(self, dataset) -> None:
        cols = _fit_columns(dataset, self.columns)
        for c in self.columns:
            vals = cols[c].astype(np.float64)
            # Interior edges cached at fit (the transform runs per
            # batch on the streaming path); nan-aware bounds.
            self.stats_[c] = np.linspace(float(np.nanmin(vals)),
                                         float(np.nanmax(vals)),
                                         self.bins + 1)[1:-1]

    def _transform_batch(self, batch: dict) -> dict:
        out = dict(batch)
        for c in self.columns:
            v = np.asarray(batch[c], dtype=np.float64)
            if np.isnan(v).any():
                # NaN would silently land in the TOP bin (NaN compares
                # greater-than in digitize) — a missing value must not
                # become a legitimate-looking category.
                raise ValueError(
                    f"NaN in {c!r}: impute (SimpleImputer) before "
                    "discretizing")
            out[c] = np.clip(np.digitize(v, self.stats_[c]), 0,
                             self.bins - 1).astype(np.int64)
        return out


# -- text family (reference: preprocessors/{tokenizer,hasher,
# vectorizer}.py) ------------------------------------------------------------


def _default_tokenize(s: str) -> list[str]:
    """The reference's simple_split_tokenizer: lowercase, split on
    non-alphanumeric runs."""
    import re

    return [t for t in re.split(r"[^a-z0-9]+", str(s).lower()) if t]


class Tokenizer(Preprocessor):
    """String column -> list-of-tokens column (reference:
    tokenizer.py Tokenizer). Stateless; tokenization_fn pluggable."""

    _is_fittable = False

    def __init__(self, columns: list[str], tokenization_fn=None):
        super().__init__()
        self.columns = list(columns)
        self.tokenization_fn = tokenization_fn or _default_tokenize

    def _transform_batch(self, batch: dict) -> dict:
        out = dict(batch)
        for c in self.columns:
            cells = np.asarray(batch[c]).tolist()
            # 1-D object array of LISTS: np.asarray would collapse
            # equal-length token lists into a 2-D array.
            col = np.empty(len(cells), dtype=object)
            for i, s in enumerate(cells):
                col[i] = self.tokenization_fn(s)
            out[c] = col
        return out


class FeatureHasher(Preprocessor):
    """Token-count columns -> fixed-width hashed feature matrix
    (reference: hasher.py FeatureHasher — the hashing trick keeps
    vocabulary out of memory). Stateless; input columns hold token
    LISTS (e.g. Tokenizer output) or raw strings."""

    _is_fittable = False

    def __init__(self, columns: list[str], num_features: int,
                 output_column_name: str = "hashed_features"):
        super().__init__()
        self.columns = list(columns)
        self.num_features = int(num_features)
        self.output_column_name = output_column_name

    def _transform_batch(self, batch: dict) -> dict:
        import zlib

        out = dict(batch)
        n = len(np.asarray(batch[self.columns[0]], dtype=object))
        mat = np.zeros((n, self.num_features), dtype=np.float32)
        for c in self.columns:
            col = np.asarray(batch[c], dtype=object)
            for i, cell in enumerate(col.tolist()):
                tokens = (cell if isinstance(cell, (list, tuple, np.ndarray))
                          else _default_tokenize(cell))
                for tok in tokens:
                    h = zlib.crc32(f"{c}={tok}".encode()) % self.num_features
                    mat[i, h] += 1.0
            out.pop(c, None)
        out[self.output_column_name] = mat
        return out


class CountVectorizer(Preprocessor):
    """Fit a vocabulary over a text column; transform to per-token
    count columns ``{col}_{token}`` for the top max_features tokens
    (reference: vectorizer.py CountVectorizer)."""

    def __init__(self, columns: list[str], tokenization_fn=None,
                 max_features: int | None = None):
        super().__init__()
        self.columns = list(columns)
        self.tokenization_fn = tokenization_fn or _default_tokenize
        self.max_features = max_features
        self.stats_: dict[str, list] = {}

    def _fit(self, dataset) -> None:
        from collections import Counter

        cols = _fit_columns(dataset, self.columns)
        for c in self.columns:
            counts: Counter = Counter()
            for s in cols[c].tolist():
                counts.update(self.tokenization_fn(s))
            vocab = (counts.most_common(self.max_features)
                     if self.max_features else sorted(counts.items()))
            self.stats_[c] = sorted(t for t, _ in vocab)

    def _transform_batch(self, batch: dict) -> dict:
        from collections import Counter

        out = dict(batch)
        for c in self.columns:
            vocab = self.stats_[c]
            cells = np.asarray(out.pop(c), dtype=object).tolist()
            token_counts = [Counter(self.tokenization_fn(s))
                            for s in cells]
            for tok in vocab:
                out[f"{c}_{tok}"] = np.asarray(
                    [tc.get(tok, 0) for tc in token_counts],
                    dtype=np.int64)
        return out


class HashingVectorizer(Preprocessor):
    """Text column -> fixed-width hashed count matrix, no fitted
    vocabulary (reference: vectorizer.py HashingVectorizer)."""

    _is_fittable = False

    def __init__(self, columns: list[str], num_features: int,
                 tokenization_fn=None):
        super().__init__()
        self.columns = list(columns)
        self.num_features = int(num_features)
        self.tokenization_fn = tokenization_fn or _default_tokenize

    def _transform_batch(self, batch: dict) -> dict:
        import zlib

        out = dict(batch)
        for c in self.columns:
            cells = np.asarray(out.pop(c), dtype=object).tolist()
            mat = np.zeros((len(cells), self.num_features),
                           dtype=np.float32)
            for i, s in enumerate(cells):
                for tok in self.tokenization_fn(s):
                    mat[i, zlib.crc32(tok.encode())
                        % self.num_features] += 1.0
            out[f"{c}_hashed"] = mat
        return out


class MaxAbsScaler(Preprocessor):
    """x / max(|x|) per column (reference: scaler.py MaxAbsScaler)."""

    def __init__(self, columns: list[str]):
        super().__init__()
        self.columns = list(columns)
        self.stats_: dict[str, float] = {}

    def _fit(self, dataset) -> None:
        cols = _fit_columns(dataset, self.columns)
        for c in self.columns:
            vals = cols[c].astype(np.float64)
            self.stats_[c] = float(np.nanmax(np.abs(vals)))

    def _transform_batch(self, batch: dict) -> dict:
        out = dict(batch)
        for c in self.columns:
            m = self.stats_[c]
            v = np.asarray(batch[c], dtype=np.float64)
            out[c] = v / m if m > 0 else np.zeros_like(v)
        return out


class MultiHotEncoder(Preprocessor):
    """List-valued column -> fixed-width multi-hot count vector over the
    fitted vocabulary (reference: encoder.py MultiHotEncoder — e.g. a
    movie's genre list)."""

    def __init__(self, columns: list[str]):
        super().__init__()
        self.columns = list(columns)
        self.stats_: dict[str, list] = {}

    def _fit(self, dataset) -> None:
        cols = _fit_columns(dataset, self.columns)
        for c in self.columns:
            vocab: set = set()
            for cell in cols[c].tolist():
                vocab.update(cell if isinstance(
                    cell, (list, tuple, np.ndarray)) else [cell])
            self.stats_[c] = sorted(vocab)

    def _transform_batch(self, batch: dict) -> dict:
        out = dict(batch)
        for c in self.columns:
            vocab = {v: i for i, v in enumerate(self.stats_[c])}
            cells = np.asarray(batch[c], dtype=object).tolist()
            mat = np.zeros((len(cells), len(vocab)), dtype=np.int64)
            for i, cell in enumerate(cells):
                items = (cell if isinstance(cell, (list, tuple, np.ndarray))
                         else [cell])
                for item in items:
                    j = vocab.get(item)
                    if j is not None:
                        mat[i, j] += 1
            out[c] = mat
        return out


class PowerTransformer(Preprocessor):
    """Yeo-Johnson / Box-Cox power transform with a user-chosen power
    (reference: transformer.py PowerTransformer — the reference also
    takes the power as a parameter rather than estimating it).
    Stateless. Box-Cox requires positive data."""

    _is_fittable = False

    def __init__(self, columns: list[str], power: float,
                 method: str = "yeo-johnson"):
        super().__init__()
        if method not in ("yeo-johnson", "box-cox"):
            raise ValueError(f"unknown method {method!r}")
        self.columns = list(columns)
        self.power = float(power)
        self.method = method

    def _transform_batch(self, batch: dict) -> dict:
        lmb = self.power
        out = dict(batch)
        for c in self.columns:
            v = np.asarray(batch[c], dtype=np.float64)
            if self.method == "box-cox":
                if (v <= 0).any():
                    raise ValueError("box-cox requires positive data")
                out[c] = (np.log(v) if lmb == 0
                          else (np.power(v, lmb) - 1) / lmb)
                continue
            # yeo-johnson, piecewise around 0
            pos = v >= 0
            r = np.empty_like(v)
            if lmb != 0:
                r[pos] = (np.power(v[pos] + 1, lmb) - 1) / lmb
            else:
                r[pos] = np.log1p(v[pos])
            if lmb != 2:
                r[~pos] = -(np.power(1 - v[~pos], 2 - lmb) - 1) / (2 - lmb)
            else:
                r[~pos] = -np.log1p(-v[~pos])
            out[c] = r
        return out
