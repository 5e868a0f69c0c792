"""ray_tpu_torch.data: streaming datasets for training pipelines (port of
ray_tpu.data).

Counterpart of the reference's python/ray/data (SURVEY.md §2.3 — Dataset
builds a logical plan run by a streaming executor over the cluster;
blocks are Arrow tables / numpy dicts). Batches come out as numpy or as
torch tensors on a device (``iter_torch_batches``, the card unless the
caller asks for the CPU); ``streaming_split`` feeds TorchTrainer workers.
pyarrow, pandas, PIL and tensorflow are optional, imported where a
block, source or sink needs them; numpy-dict blocks always work."""

from ray_tpu_torch.data.actor_pool import ActorPoolStrategy
from ray_tpu_torch.data.block import Block, BlockAccessor, BlockMetadata
from ray_tpu_torch.data.datasource import Datasource, ReadTask
from ray_tpu_torch.data.dataset import (
    DataContext,
    DataIterator,
    Dataset,
    Datasink,
    from_arrow,
    from_items,
    from_numpy,
    from_pandas,
    range,
    range_tensor,
    from_huggingface,
    from_torch,
    read_binary_files,
    read_datasource,
    read_csv,
    read_json,
    read_images,
    read_numpy,
    read_parquet,
    read_sql,
    read_text,
    read_tfrecords,
    read_avro,
    read_webdataset,
    read_parquet_bulk,
    from_blocks,
    from_pandas_refs,
    from_numpy_refs,
    from_arrow_refs,
    from_tf,
)

__all__ = [
    "ActorPoolStrategy",
    "Block",
    "BlockAccessor",
    "BlockMetadata",
    "DataContext",
    "DataIterator",
    "Dataset",
    "Datasink",
    "from_arrow",
    "from_items",
    "from_numpy",
    "from_pandas",
    "range",
    "range_tensor",
    "from_huggingface",
    "from_torch",
    "read_binary_files",
    "read_datasource",
    "Datasource",
    "ReadTask",
    "read_csv",
    "read_json",
    "read_images",
    "read_numpy",
    "read_parquet",
    "read_sql",
    "read_text",
    "read_tfrecords",
    "read_avro",
    "read_webdataset",
    "read_parquet_bulk",
    "from_blocks",
    "from_pandas_refs",
    "from_numpy_refs",
    "from_arrow_refs",
    "from_tf",
]

# Preprocessors ride the package namespace like the reference's
# ray.data.preprocessors (fit via Dataset aggregates, transform via
# map_batches).
from ray_tpu_torch.data import preprocessors  # noqa: E402,F401
