"""Placement groups: gang reservation of resource bundles.

Analog of the reference (reference: python/ray/util/placement_group.py:33
PlacementGroup, :128 placement_group(); strategies :130-146 PACK/SPREAD/
STRICT_PACK/STRICT_SPREAD; backed by the GCS 2-phase scheduler
src/ray/gcs/gcs_server/gcs_placement_group_scheduler.cc).

STRICT_PACK puts all bundles on one node: the strategy for a gang whose
workers share one host's cards.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ray_tpu_torch._private.ids import PlacementGroupID
from ray_tpu_torch._private.protocol import MsgType

VALID_STRATEGIES = ("PACK", "SPREAD", "STRICT_PACK", "STRICT_SPREAD")


class PlacementGroup:
    def __init__(self, pg_id: bytes, bundles: List[Dict[str, float]]):
        self.id = pg_id
        self._bundles = bundles

    @property
    def bundle_specs(self) -> List[Dict[str, float]]:
        return self._bundles

    @property
    def bundle_count(self) -> int:
        return len(self._bundles)

    def ready(self, timeout: Optional[float] = None):
        """Block until all bundles are reserved.  Returns an ObjectRef-like
        immediate in the reference; here a bool for simplicity plus a
        .wait()-style blocking call."""
        from ray_tpu_torch._private import worker as worker_mod

        cw = worker_mod._require_connected()
        reply = cw.request(
            MsgType.PG_READY,
            {"pg_id": self.id, "timeout": timeout},
            timeout=(timeout + 5) if timeout else 3600,
        )
        return reply["ready"]

    def wait(self, timeout_seconds: Optional[float] = 30) -> bool:
        return self.ready(timeout_seconds)

    def __reduce__(self):
        return (PlacementGroup, (self.id, self._bundles))


def placement_group(
    bundles: List[Dict[str, float]],
    strategy: str = "PACK",
    name: str = "",
    lifetime: Optional[str] = None,
) -> PlacementGroup:
    from ray_tpu_torch._private import worker as worker_mod

    cw = worker_mod._require_connected()
    if strategy not in VALID_STRATEGIES:
        raise ValueError(f"Invalid strategy {strategy!r}; want one of {VALID_STRATEGIES}")
    if not bundles:
        raise ValueError("placement group needs at least one bundle")
    for b in bundles:
        if not b or any(v < 0 for v in b.values()):
            raise ValueError(f"invalid bundle {b}")
    pg_id = PlacementGroupID.of(cw.job_id).binary()
    cw.request(
        MsgType.CREATE_PG,
        {"pg_id": pg_id, "bundles": bundles, "strategy": strategy, "name": name},
    )
    return PlacementGroup(pg_id, bundles)


def remove_placement_group(pg: PlacementGroup):
    from ray_tpu_torch._private import worker as worker_mod

    cw = worker_mod._require_connected()
    cw.request(MsgType.REMOVE_PG, {"pg_id": pg.id})


def placement_group_table(pg: Optional[PlacementGroup] = None) -> dict:
    from ray_tpu_torch._private import worker as worker_mod

    cw = worker_mod._require_connected()
    if pg is not None:
        reply = cw.request(MsgType.GET_PG, {"pg_id": pg.id})
        return reply
    return cw.request(MsgType.LIST_PGS, {})
