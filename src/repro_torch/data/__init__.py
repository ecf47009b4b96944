"""The synthetic training data pipeline (port of ``repro.data``)."""
from .pipeline import Batch, PipelineConfig, SyntheticLM

__all__ = ["Batch", "PipelineConfig", "SyntheticLM"]
