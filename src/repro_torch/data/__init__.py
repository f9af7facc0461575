"""The token pipeline of the port (counterpart of ``repro.data``)."""
from repro_torch.data.pipeline import DataConfig, batch_at, make_pipeline

__all__ = ["DataConfig", "batch_at", "make_pipeline"]
