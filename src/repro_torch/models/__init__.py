"""Models of the port (counterpart of ``repro.models``)."""
from repro_torch.models.registry import Model, build_model

__all__ = ["Model", "build_model"]
