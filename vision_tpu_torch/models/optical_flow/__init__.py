"""Optical flow (counterpart of ``vision_tpu/models/optical_flow``): RAFT."""

from vision_tpu_torch.models.optical_flow.raft import (
    RAFT,
    Raft_Large_Weights,
    Raft_Small_Weights,
    raft_large,
    raft_small,
)

__all__ = ["RAFT", "Raft_Large_Weights", "Raft_Small_Weights", "raft_large",
           "raft_small"]
