"""DAG declaration API: bind actor methods into a static dataflow graph.

Analog of the reference's compiled-graph (aDAG) authoring surface
(reference: python/ray/dag/ — ClassMethodNode via ``actor.method.bind``,
InputNode as the per-execution argument, MultiOutputNode for multi-sink
graphs).  Declaration is pure bookkeeping: nothing talks to the cluster
until ``.compile()`` (ray_tpu_torch/dag/compiled.py) resolves the topology and
wires channels.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple


class DAGNode:
    """Base of every declaration node.  A node's upstream dependencies are
    the DAGNode instances appearing in its bound args/kwargs."""

    def upstream(self) -> List["DAGNode"]:
        return []

    def compile(self, **options):
        """Resolve the graph reachable from this node (treated as the
        output) into a :class:`~ray_tpu_torch.dag.compiled.CompiledDag` with
        pre-wired channels and resident executors."""
        from ray_tpu_torch.dag.compiled import CompiledDag

        return CompiledDag(self, **options)


class InputNode(DAGNode):
    """The per-execution input: ``compiled.execute(x)`` feeds ``x`` to every
    node that bound this.  A graph has at most one InputNode; it is
    broadcast to all its consumers.  Usable as a context manager for the
    reference's ``with InputNode() as inp:`` idiom."""

    def __enter__(self) -> "InputNode":
        return self

    def __exit__(self, *exc) -> None:
        return None

    def __repr__(self):
        return "InputNode()"


class ClassMethodNode(DAGNode):
    """One bound actor-method invocation in the graph — created by
    ``actor.method.bind(*args, **kwargs)``.  Args may be DAGNode instances
    (dataflow edges) or plain values (constants shipped once at compile,
    never per step)."""

    def __init__(self, handle, method_name: str, args: Tuple[Any, ...], kwargs: Dict[str, Any]):
        self._handle = handle
        self._method_name = method_name
        self._bound_args = tuple(args)
        self._bound_kwargs = dict(kwargs)
        self._dag_options: Dict[str, Any] = {}

    def options(self, *, lock: bool = True) -> "ClassMethodNode":
        """Per-node execution options, chainable after ``bind``.

        ``lock=False`` runs this node's resident executor WITHOUT the
        actor's sequential-execution lock, so it can overlap other nodes
        (and eager calls) on the same actor — the double-buffered feeder
        stage of a resident train loop needs exactly this.  Contract: an
        unlocked node must only touch state that is disjoint from (or
        thread-safe against) everything the locked nodes and eager calls
        mutate.
        """
        self._dag_options["lock"] = bool(lock)
        return self

    @property
    def dag_options(self) -> Dict[str, Any]:
        return self._dag_options

    @property
    def method_name(self) -> str:
        return self._method_name

    @property
    def handle(self):
        return self._handle

    def upstream(self) -> List[DAGNode]:
        deps = [a for a in self._bound_args if isinstance(a, DAGNode)]
        deps += [v for v in self._bound_kwargs.values() if isinstance(v, DAGNode)]
        return deps

    def bind_info(self) -> Tuple[Tuple[Any, ...], Dict[str, Any]]:
        return self._bound_args, self._bound_kwargs

    def __repr__(self):
        return f"ClassMethodNode({self._handle._class_name}.{self._method_name})"


class MultiOutputNode(DAGNode):
    """Marks several nodes as the graph's outputs; ``execute`` returns
    their values as a list in declaration order."""

    def __init__(self, outputs: List[DAGNode]):
        outs = list(outputs)
        if not outs:
            raise ValueError("MultiOutputNode needs at least one output node")
        for o in outs:
            if not isinstance(o, ClassMethodNode):
                raise TypeError(
                    "MultiOutputNode outputs must be bound actor-method nodes "
                    f"(got {type(o).__name__}); an InputNode passthrough has "
                    "no producing executor"
                )
        self._outputs = outs

    @property
    def outputs(self) -> List[ClassMethodNode]:
        return list(self._outputs)

    def upstream(self) -> List[DAGNode]:
        return list(self._outputs)

    def __repr__(self):
        return f"MultiOutputNode({len(self._outputs)} outputs)"


def resolve_topology(output: DAGNode) -> Tuple[List[ClassMethodNode], InputNode, List[ClassMethodNode]]:
    """Walk the graph reachable from ``output``; return (topo-ordered
    method nodes, the InputNode or None, the output method nodes).
    Raises on cycles, multiple InputNodes, or an unusable output."""
    if isinstance(output, MultiOutputNode):
        sinks = output.outputs
    elif isinstance(output, ClassMethodNode):
        sinks = [output]
    else:
        raise TypeError(
            "compile() target must be a bound actor-method node or a "
            f"MultiOutputNode, not {type(output).__name__}"
        )

    order: List[ClassMethodNode] = []
    input_nodes: List[InputNode] = []
    VISITING, DONE = 1, 2
    state: Dict[int, int] = {}

    def visit(node: DAGNode):
        key = id(node)
        if state.get(key) == DONE:
            return
        if state.get(key) == VISITING:
            raise ValueError("cycle detected in DAG: static dataflow must be acyclic")
        state[key] = VISITING
        if isinstance(node, InputNode):
            if node not in input_nodes:
                input_nodes.append(node)
        else:
            for dep in node.upstream():
                visit(dep)
            if isinstance(node, ClassMethodNode):
                order.append(node)
        state[key] = DONE

    for s in sinks:
        visit(s)
    if len(input_nodes) > 1:
        raise ValueError("a DAG may declare at most one InputNode")
    return order, (input_nodes[0] if input_nodes else None), sinks
