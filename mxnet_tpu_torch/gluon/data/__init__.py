"""Gluon data API (counterpart of ``mxnet_tpu/gluon/data``; reference
python/mxnet/gluon/data/)."""
from . import vision  # noqa: F401
from .dataloader import DataLoader, default_batchify_fn  # noqa: F401
from .dataset import (ArrayDataset, Dataset, RecordFileDataset,  # noqa: F401
                      SimpleDataset)
from .sampler import (BatchSampler, RandomSampler, Sampler,  # noqa: F401
                      SequentialSampler)
