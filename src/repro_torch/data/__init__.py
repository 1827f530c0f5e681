"""Training data: the deterministic synthetic LM stream."""
from .pipeline import DataConfig, SyntheticLMData
