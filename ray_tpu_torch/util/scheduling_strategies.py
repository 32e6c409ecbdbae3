"""Scheduling strategies (reference: ray/util/scheduling_strategies.py).

Tasks and actors accept ``scheduling_strategy=`` in options; the strategy
objects here are plain data the submit path reads attributes from."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass
class NodeAffinitySchedulingStrategy:
    """Pin to a specific node (reference:
    util/scheduling_strategies.py NodeAffinitySchedulingStrategy).
    node_id is the hex string from ray_tpu_torch.nodes()[i]["NodeID"]."""

    node_id: str
    soft: bool = False


@dataclass
class PlacementGroupSchedulingStrategy:
    """Schedule into a placement group bundle (reference:
    util/scheduling_strategies.py PlacementGroupSchedulingStrategy)."""

    placement_group: object
    placement_group_bundle_index: int = -1
    placement_group_capture_child_tasks: Optional[bool] = None
