from repro_torch.models.api import get_model

__all__ = ["get_model"]
