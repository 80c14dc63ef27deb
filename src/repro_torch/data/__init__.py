"""The synthetic LM data pipeline of the port."""
from repro_torch.data.pipeline import SyntheticLMDataset

__all__ = ["SyntheticLMDataset"]
