from ray_tpu_torch.util.placement_group import (  # noqa: F401
    PlacementGroup,
    placement_group,
    placement_group_table,
    remove_placement_group,
)
