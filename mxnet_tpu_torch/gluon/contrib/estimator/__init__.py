"""The Estimator fit loop and its event handlers (counterpart of
``mxnet_tpu/gluon/contrib/estimator``)."""
from .estimator import Estimator  # noqa: F401
from .event_handler import (BatchBegin, BatchEnd,  # noqa: F401
                            CheckpointHandler, EarlyStoppingHandler,
                            EpochBegin, EpochEnd, LoggingHandler,
                            MetricHandler, StoppingHandler, TrainBegin,
                            TrainEnd, ValidationHandler)
