"""Shared pieces of the graph model families.

Counterpart of kmamiz_tpu/models/common.py for serving: the node-identity
embedding concatenation. The loss, optimizer and train step come with the
training slice.
"""
from __future__ import annotations

from typing import Optional

import torch


def concat_embedding(
    features: torch.Tensor, embedding: Optional[torch.Tensor]
) -> torch.Tensor:
    """Concatenate the learned node-identity embedding to the feature
    block, zero-padding it when the features carry bucket-padded node rows:
    padded nodes have no edges and are never read, so a zero identity is
    exact."""
    if embedding is None:
        return features
    pad = features.shape[0] - embedding.shape[0]
    if pad:
        embedding = torch.nn.functional.pad(embedding, (0, 0, 0, pad))
    return torch.cat([features, embedding], dim=1)
