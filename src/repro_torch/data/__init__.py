"""Input pipelines (port of `repro.data`): the training batches and the
synthetic event sources of the stream front end."""
from .events import moving_blob_events, rate_coded_events, split_into_windows
from .pipeline import SyntheticLMData, batch_shapes, batch_to_torch

__all__ = ["SyntheticLMData", "batch_shapes", "batch_to_torch", "moving_blob_events",
           "rate_coded_events", "split_into_windows"]
