"""Feature extraction (counterpart of
``vision_tpu/models/feature_extraction.py``): ``create_feature_extractor``
and ``get_graph_node_names`` over the models' own named intermediates,
``forward(x, return_features=True)``, under the JAX models' names
(``features.{i}``, ``stage{i}``, ``layer{i}``, ...), in place of
torchvision's FX tracing.
"""

from __future__ import annotations

import inspect
from typing import Dict, List, Optional, Union

import torch
from torch import nn

__all__ = ["FeatureExtractor", "create_feature_extractor",
           "get_graph_node_names"]


def _parameters_of(model: nn.Module):
    params = inspect.signature(model.forward).parameters
    if "return_features" not in params:
        raise ValueError(f"{type(model).__name__} does not expose named "
                         "intermediates (no return_features parameter)")
    return params


class FeatureExtractor(nn.Module):
    """``model``'s named intermediates: ``forward(x, generator=None)``
    returns ``{out_name: feature}`` for ``return_nodes`` (every feature
    under its own name when None), in the mode the extractor is in (a
    built model starts in eval mode). The generator reaches the model's
    stochastic layers where it takes one."""

    def __init__(self, model: nn.Module,
                 return_nodes: Optional[Dict[str, str]] = None):
        super().__init__()
        self.takes_generator = "generator" in _parameters_of(model)
        self.model = model
        self.return_nodes = return_nodes
        self.train(model.training)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        kwargs = {"generator": generator} if self.takes_generator else {}
        _, feats = self.model(x, return_features=True, **kwargs)
        if self.return_nodes is None:
            return feats
        missing = [k for k in self.return_nodes if k not in feats]
        if missing:
            raise KeyError(f"nodes {missing} not available; choose from "
                           f"{list(feats)}")
        return {out: feats[k] for k, out in self.return_nodes.items()}


def get_graph_node_names(model: nn.Module,
                         example_input: Optional[torch.Tensor] = None
                         ) -> List[str]:
    """The names ``create_feature_extractor`` can return, read from one
    eval-mode forward of ``example_input`` (zeros ``[1, 3, 64, 64]`` on
    the model's device by default)."""
    _parameters_of(model)
    if example_input is None:
        device = next(model.parameters()).device
        example_input = torch.zeros(1, 3, 64, 64, device=device)
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            _, feats = model(example_input, return_features=True)
    finally:
        model.train(was_training)
    return list(feats)


def create_feature_extractor(
    model: nn.Module,
    return_nodes: Union[List[str], Dict[str, str], None] = None,
) -> FeatureExtractor:
    """A module returning ``{out_name: feature}``; ``return_nodes`` maps
    the model's intermediate names to output names (a list maps each name
    to itself; None returns them all)."""
    if isinstance(return_nodes, list):
        return_nodes = {n: n for n in return_nodes}
    return FeatureExtractor(model, return_nodes)
