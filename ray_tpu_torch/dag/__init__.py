"""Compiled actor DAGs: static-dataflow execution with pre-wired channels.

Declare a static call graph over existing actors with ``.bind()`` /
``InputNode`` / ``MultiOutputNode``, then ``dag.compile()`` resolves the
topology ONCE, pre-wires persistent SPSC channels between participants
(shm ring slots for co-located pairs, the direct actor-call TCP conns
cross-node), and installs a resident executor loop on each participating
actor.  ``compiled.execute(x)`` is one channel write + one channel read at
the driver — no head round-trip, no per-call TaskSpec, no per-call graph
serialization (Pathways' off-the-hot-path dispatch, PAPERS.md §2, on the
Ray actor substrate, PAPERS.md §1).

The port of the JAX package's ``dag/`` (its ``dag/DESIGN.md`` states the
API, channel wiring, and the error / teardown contract, which hold here
unchanged).  Payloads cross through the port's serializer, so a
``torch.Tensor`` rides its tensor reducer.
"""

from ray_tpu_torch.dag.node import (  # noqa: F401
    ClassMethodNode,
    DAGNode,
    InputNode,
    MultiOutputNode,
)
from ray_tpu_torch.exceptions import DagExecutionError, DagInvalidatedError  # noqa: F401


def __getattr__(name):
    # lazy: importing the package for declaration must not pull the
    # driver-side compile machinery (worker connection) in
    if name in ("CompiledDag", "DagStepFuture"):
        from ray_tpu_torch.dag import compiled

        return getattr(compiled, name)
    raise AttributeError(name)
