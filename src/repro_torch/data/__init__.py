"""Deterministic synthetic LM data (the port of ``repro.data``)."""
from .pipeline import DataConfig, SyntheticLMStream, make_stream

__all__ = ["DataConfig", "SyntheticLMStream", "make_stream"]
