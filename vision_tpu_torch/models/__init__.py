"""Models (counterpart of ``vision_tpu/models``)."""

from vision_tpu_torch.models import detection
from vision_tpu_torch.models._api import get_model, list_models

__all__ = ["detection", "get_model", "list_models"]
