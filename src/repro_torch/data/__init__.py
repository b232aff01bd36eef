"""The synthetic-token data pipeline (port of ``repro.data``)."""
from .pipeline import DataPipeline, PipelineState

__all__ = ["DataPipeline", "PipelineState"]
