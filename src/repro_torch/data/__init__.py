"""Input pipelines of the training path (port of `repro.data`)."""
from .pipeline import SyntheticLMData, batch_to_torch

__all__ = ["SyntheticLMData", "batch_to_torch"]
