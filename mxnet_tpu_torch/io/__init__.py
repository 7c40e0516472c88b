"""mx.io — the DataIter protocol and iterators (counterpart of
``mxnet_tpu/io``; reference ``python/mxnet/io/io.py``): host-side batches,
staged onto the card by ``DeviceFeedIter``."""
from .io import (DataDesc, DataBatch, DataIter, NDArrayIter, ResizeIter,
                 PrefetchingIter, CSVIter, LibSVMIter, MNISTIter,
                 ImageRecordIter)
from .device_feed import (DeviceFeedIter, make_normalize_transform,
                          stage_on_device)

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter", "ResizeIter",
           "PrefetchingIter", "CSVIter", "LibSVMIter", "MNISTIter",
           "ImageRecordIter", "DeviceFeedIter", "stage_on_device",
           "make_normalize_transform"]
