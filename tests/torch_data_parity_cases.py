"""One script run under ray_tpu and under ray_tpu_torch, each in its own
process, by tests/test_torch_data_parity.py:

    python tests/torch_data_parity_cases.py ray_tpu|ray_tpu_torch OUT_DIR

The same Data pipelines on one cluster (head_shards=1): take_all of a
map/filter chain, sort (both ways), a seeded shuffle, groupby
aggregates, a union, a zip, splits, preprocessors' fitted statistics and
transforms, and files written (parquet, csv, json, numpy, tfrecords)
then read back. Each package writes under its own OUT_DIR. It prints
one JSON object of rows and statistics, and imports only the package it
is given, so the ray_tpu_torch run loads neither jax nor ray_tpu.
"""

import importlib
import json
import os
import sys

import numpy as np


def plain(x):
    """Rows and statistics as JSON: numpy scalars and arrays as lists."""
    if isinstance(x, dict):
        return {str(k): plain(v) for k, v in sorted(x.items())}
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    if isinstance(x, np.ndarray):
        return plain(x.tolist())
    if isinstance(x, np.generic):
        return plain(x.item())
    if isinstance(x, bytes):
        return x.decode("latin-1")
    return x


def main(pkg: str, out_dir: str) -> dict:
    rt = importlib.import_module(pkg)
    rd = importlib.import_module(pkg + ".data")
    pp = importlib.import_module(pkg + ".data.preprocessors")
    rt.init(num_cpus=4, object_store_memory=64 * 1024 * 1024,
            _system_config={"head_shards": 1})
    out = {}
    rng = np.random.default_rng(0)
    items = [{"k": f"g{int(rng.integers(4))}", "v": float(rng.standard_normal()),
              "n": int(rng.integers(100))} for _ in range(60)]

    out["map_filter"] = rd.range(100, parallelism=4).map_batches(
        lambda b: {"id": b["id"] * 3}).filter(lambda r: r["id"] % 2 == 0).take_all()
    out["map_rows"] = rd.from_items(items[:10]).map(
        lambda r: {"k": r["k"] + "!", "twice": 2 * r["n"]}).take_all()
    out["sort"] = rd.from_items(items).sort("n").take_all()
    out["sort_desc"] = rd.from_items(items).sort("v", descending=True).take(10)
    out["shuffle"] = rd.range(50, parallelism=5).random_shuffle(seed=7).take_all()
    g = rd.from_items(items).groupby("k")
    out["group_count"] = g.count().take_all()
    out["group_sum"] = g.sum("n").take_all()
    out["group_mean"] = g.mean(["v", "n"]).take_all()
    out["group_std"] = g.std("v").take_all()
    out["group_agg"] = g.aggregate(top=("n", np.max), low=("v", np.min)).take_all()
    out["stats"] = [rd.from_items(items).sum("n"), rd.from_items(items).mean("v"),
                    rd.from_items(items).std("v"), rd.from_items(items).unique("k")]
    out["union"] = rd.range(5).union(rd.range(3)).take_all()
    out["zip"] = rd.range(6).zip(rd.from_items([{"x": i * i} for i in range(6)])).take_all()
    out["split"] = [p.take_all() for p in rd.range(10).split(3)]
    out["split_at"] = [p.take_all() for p in rd.range(10).split_at_indices([2, 7])]
    out["limit_repartition"] = [rd.range(40).repartition(3).limit(11).take_all(),
                                rd.range(40).repartition(3).num_blocks()
                                if hasattr(rd.Dataset, "num_blocks") else None]
    out["batches"] = [len(b["id"]) for b in rd.range(70).iter_batches(batch_size=32)]

    # Preprocessors: fitted statistics and a transform.
    ds = rd.from_items(items)
    nums = rd.from_items([{"a": float(i % 7), "b": float(i) ** 1.5,
                           "c": ["x", "y", "z"][i % 3]} for i in range(30)])
    fitted = {}
    for name, p in [("standard", pp.StandardScaler(["v", "n"])),
                    ("minmax", pp.MinMaxScaler(["v"])),
                    ("robust", pp.RobustScaler(["n"])),
                    ("onehot", pp.OneHotEncoder(["k"])),
                    ("ordinal", pp.OrdinalEncoder(["k"])),
                    ("label", pp.LabelEncoder("k")),
                    ("impute", pp.SimpleImputer(["v"], strategy="mean"))]:
        p.fit(ds)
        fitted[name] = p.stats_
    out["fitted"] = fitted
    chain = pp.Chain(pp.StandardScaler(["a", "b"]), pp.OneHotEncoder(["c"]),
                     pp.Concatenator(["a", "b"], output_column_name="feat"))
    out["chain_rows"] = chain.fit_transform(nums).take(5)
    out["discretize"] = pp.UniformKBinsDiscretizer(["b"], bins=4).fit_transform(
        nums).take_all()

    # Files written, then read back.
    tab = rd.from_items([{"a": i, "b": float(i) / 4, "s": f"r{i}"} for i in range(12)])
    tab.write_parquet(os.path.join(out_dir, "pq"))
    out["parquet"] = rd.read_parquet(os.path.join(out_dir, "pq")).sort("a").take_all()
    tab.write_csv(os.path.join(out_dir, "csv"))
    out["csv"] = rd.read_csv(os.path.join(out_dir, "csv")).sort("a").take_all()
    tab.write_json(os.path.join(out_dir, "json"))
    out["json"] = rd.read_json(os.path.join(out_dir, "json")).sort("a").take_all()
    rd.from_numpy(np.arange(24).reshape(6, 4)).write_numpy(os.path.join(out_dir, "npy"),
                                                           column="data")
    out["numpy"] = rd.read_numpy(os.path.join(out_dir, "npy")).take_all()
    rd.from_items([{"x": i, "name": f"n{i}".encode()} for i in range(5)]).write_tfrecords(
        os.path.join(out_dir, "tfr"))
    out["tfrecords"] = rd.read_tfrecords(os.path.join(out_dir, "tfr")).take_all()

    rt.shutdown()
    out = plain(out)
    out["foreign_modules"] = sorted(
        m for m in sys.modules
        if m.split(".")[0] in ("jax", "ray_tpu") and pkg != "ray_tpu")
    return out


if __name__ == "__main__":
    print(json.dumps(main(sys.argv[1], sys.argv[2]), sort_keys=True))
