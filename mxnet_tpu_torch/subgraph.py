"""Generic subgraph partition framework (the counterpart of
`mxnet_tpu/subgraph.py`; reference `src/operator/subgraph/subgraph_property.h`
+ `build_subgraph.cc`).

A matched region becomes ONE `_subgraph_op` node whose attrs carry the
inner graph's JSON; executing the node runs the inner graph through the op
registry.  The pass is graph code with no device in it and gives the JAX
package's partitioned Symbol JSON, character for character, for the same
graph.  The port uses it for `graph_compile`'s captured islands.

Surface:
  * ``SubgraphSelector`` -- Select/SelectInput/SelectOutput growth
    protocol (`subgraph_property.h:54`)
  * ``SubgraphProperty`` -- creates selectors, names the fused op
  * ``register_subgraph_property`` / ``get_subgraph_property`` registry
  * ``partition(sym, prop)`` -- graph pass producing the rewritten Symbol
  * env activation: ``MXNET_SUBGRAPH_BACKEND=<name>`` applies the pass
    at bind time (`build_subgraph.cc` reads the same variable)

Regions are grown connected and then shrunk to convexity (no path from
inside the region through an outside node back inside -- the reference's
cycle check), so every fused node is a valid single op.
"""
from __future__ import annotations

import json
from typing import Dict, List, Type

from . import config
from .base import MXNetError

__all__ = ["SubgraphSelector", "SubgraphProperty",
           "register_subgraph_property", "get_subgraph_property",
           "list_subgraph_properties", "partition"]


class SubgraphSelector:
    """Region-growing protocol: `Select` seeds a region at a node,
    `SelectInput`/`SelectOutput` decide whether to grow across an edge."""

    def select(self, node) -> bool:
        return False

    def select_input(self, node, input_node) -> bool:
        return self.select(input_node)

    def select_output(self, node, output_node) -> bool:
        return self.select(output_node)


class OpNameSelector(SubgraphSelector):
    """Select any op whose name is in the given set."""

    def __init__(self, op_names):
        self.op_names = frozenset(op_names)

    def select(self, node) -> bool:
        return (not node.is_var) and node.op in self.op_names


class SubgraphProperty:
    """Subclass and register: one instance per partition pass."""

    #: op name used for the fused nodes this property creates
    subgraph_op = "_subgraph_op"

    def create_subgraph_selector(self) -> SubgraphSelector:
        raise NotImplementedError

    def min_nodes(self) -> int:
        """Regions smaller than this stay unfused (a 1-node subgraph
        only adds indirection)."""
        return 2


_REGISTRY: Dict[str, Type[SubgraphProperty]] = {}


def register_subgraph_property(name: str):
    def deco(cls):
        _REGISTRY[name] = cls
        return cls
    return deco


def get_subgraph_property(name: str) -> SubgraphProperty:
    if name not in _REGISTRY:
        raise MXNetError(
            f"unknown subgraph property {name!r}; registered: "
            f"{sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def list_subgraph_properties() -> List[str]:
    return sorted(_REGISTRY)


# ---------------------------------------------------------------------------
# partitioning pass
# ---------------------------------------------------------------------------


def _grow_regions(nodes, prop):
    """Connected regions via seed + BFS over selector-approved edges.
    A FRESH selector per seed (reference CreateSubgraphSelector protocol
    — selectors may hold per-region match state)."""
    consumers = {}
    for n in nodes:
        for (inp, _) in n.inputs:
            consumers.setdefault(id(inp), []).append(n)
    assigned: Dict[int, int] = {}
    regions: List[List] = []
    for seed in nodes:
        selector = prop.create_subgraph_selector()
        if seed.is_var or id(seed) in assigned or not selector.select(seed):
            continue
        rid = len(regions)
        region = [seed]
        assigned[id(seed)] = rid
        frontier = [seed]
        while frontier:
            cur = frontier.pop()
            for (inp, _) in cur.inputs:
                if (not inp.is_var and id(inp) not in assigned
                        and selector.select_input(cur, inp)):
                    assigned[id(inp)] = rid
                    region.append(inp)
                    frontier.append(inp)
            for out in consumers.get(id(cur), []):
                if (not out.is_var and id(out) not in assigned
                        and selector.select_output(cur, out)):
                    assigned[id(out)] = rid
                    region.append(out)
                    frontier.append(out)
        regions.append(region)
    return regions


def _shrink_to_convex(region, nodes):
    """Drop nodes until no path leaves the region and re-enters (the
    fused node would otherwise create a cycle — reference
    `build_subgraph.cc` label/cycle check)."""
    region_ids = {id(n) for n in region}
    # reaches_out[n]: node (outside region) reachable FROM some region
    # node; if such a node feeds back into the region, the consumer-side
    # region node must be evicted.
    changed = True
    while changed:
        changed = False
        region_ids = {id(n) for n in region}
        # forward reachability from region through outside nodes
        tainted = set()  # ids of outside nodes reachable from region
        for n in nodes:  # topo order: inputs before consumers
            if id(n) in region_ids:
                continue
            for (inp, _) in n.inputs:
                if id(inp) in region_ids or id(inp) in tainted:
                    tainted.add(id(n))
                    break
        for n in list(region):
            for (inp, _) in n.inputs:
                if id(inp) in tainted:
                    region.remove(n)
                    changed = True
                    break
    return region


def _drop_condensed_cycles(nodes, regions, region_of):
    """Backstop against inter-region cycles the per-region convexity
    shrink cannot see: topologically sort the condensed graph (regions
    as supernodes); a region actually ON a cycle (self-reaching in the
    residual graph, not merely downstream of one) is dissolved and its
    nodes stay unfused.  The reference's build pass CHECK-fails here;
    we degrade gracefully — correctness first, fusion second."""
    while True:
        # condensed adjacency: supernode = region id or node id
        def super_of(n):
            rid = region_of.get(id(n))
            return ("r", rid) if rid is not None else ("n", id(n))

        indeg: Dict = {}
        adj: Dict = {}
        for n in nodes:
            sv = super_of(n)
            indeg.setdefault(sv, 0)
            for (inp, _) in n.inputs:
                su = super_of(inp)
                if su == sv:
                    continue
                adj.setdefault(su, set())
                if sv not in adj[su]:
                    adj[su].add(sv)
                    indeg[sv] = indeg.get(sv, 0) + 1
                indeg.setdefault(su, 0)
        # Kahn
        ready = [v for v, d in indeg.items() if d == 0]
        seen = 0
        while ready:
            v = ready.pop()
            seen += 1
            for w in adj.get(v, ()):
                indeg[w] -= 1
                if indeg[w] == 0:
                    ready.append(w)
        if seen == len(indeg):
            return  # acyclic
        # residual supernodes (indeg>0) include cycle members AND their
        # downstream; dissolve only a SELF-REACHING region
        residual = {v for v, d in indeg.items() if d > 0}

        def on_cycle(v):
            stack, visited = list(adj.get(v, ())), set()
            while stack:
                w = stack.pop()
                if w == v:
                    return True
                if w in visited or w not in residual:
                    continue
                visited.add(w)
                stack.extend(adj.get(w, ()))
            return False

        rid = next(v[1] for v in residual
                   if v[0] == "r" and on_cycle(v))
        for n in regions[rid]:
            region_of.pop(id(n), None)
        regions[rid] = []


def partition(sym, prop) -> "object":
    """Return a new Symbol where every maximal convex region accepted by
    ``prop``'s selector is replaced by one fused ``_subgraph_op`` node."""
    from .symbol.symbol import Symbol, _Node, _topo, _entry_key

    if isinstance(prop, str):
        prop = get_subgraph_property(prop)
    nodes = _topo(sym._heads)
    orig_pos = {id(n): i for i, n in enumerate(nodes)}
    regions = [r for r in
               (_shrink_to_convex(r, nodes)
                for r in _grow_regions(nodes, prop))
               if len(r) >= prop.min_nodes()]
    region_of = {}
    for rid, region in enumerate(regions):
        for n in region:
            region_of[id(n)] = rid
    _drop_condensed_cycles(nodes, regions, region_of)

    # deep graphs: the memoized rebuild below recurses ~3 frames/node
    import sys
    sys.setrecursionlimit(max(sys.getrecursionlimit(),
                              4 * len(nodes) + 200))

    # entries consumed from outside each region -> subgraph outputs
    consumed_outside: Dict[int, List] = {rid: [] for rid in
                                         range(len(regions))}

    def note_outside_use(entry):
        node, idx = entry
        rid = region_of.get(id(node))
        if rid is not None and (node, idx) not in consumed_outside[rid]:
            consumed_outside[rid].append((node, idx))

    for n in nodes:
        for (inp, idx) in n.inputs:
            if region_of.get(id(inp)) is not None and \
                    region_of.get(id(inp)) != region_of.get(id(n)):
                note_outside_use((inp, idx))
    for (h, idx) in sym._heads:
        if region_of.get(id(h)) is not None:
            note_outside_use((h, idx))

    # rebuild the graph with each region condensed to one fused node —
    # memoized recursion over the condensed DAG (acyclic by the
    # convexity shrink, so this terminates)
    fused: Dict[int, _Node] = {}
    entry_slot: Dict[int, Dict] = {}
    new_of: Dict[int, _Node] = {}

    def rebuilt_entry(entry):
        node, idx = entry
        rid = region_of.get(id(node))
        if rid is not None:
            return (get_fused(rid),
                    entry_slot[rid][_entry_key((node, idx))])
        return (get_new(node), idx)

    def get_new(node):
        if id(node) in new_of:
            return new_of[id(node)]
        built = node if node.is_var else _Node(
            node.op, node.name, dict(node.attrs),
            [rebuilt_entry(e) for e in node.inputs])
        new_of[id(node)] = built
        return built

    def get_fused(rid):
        if rid in fused:
            return fused[rid]
        region_ids = {id(x) for x in regions[rid]}
        # external input entries, ordered by the ORIGINAL graph's
        # traversal position — argument order is part of the executor
        # contract (reference: partitioned_sym.list_arguments() ==
        # sym.list_arguments(), bind is positional)
        ext_entries: List = []
        for node_ in [x for x in nodes if id(x) in region_ids]:
            for e in node_.inputs:
                if id(e[0]) not in region_ids and e not in ext_entries:
                    ext_entries.append(e)
        ext_entries.sort(key=lambda e: (orig_pos.get(id(e[0]), 0), e[1]))
        # inner graph: a fresh var per external entry
        inner_var = {}
        inner_nodes: Dict[int, _Node] = {}
        input_names = []
        for i, e in enumerate(ext_entries):
            vname = f"__sg_in{i}"
            inner_var[(id(e[0]), e[1])] = _Node(None, vname, {}, [])
            input_names.append(vname)

        def inner_entry(e):
            if (id(e[0]), e[1]) in inner_var:
                return (inner_var[(id(e[0]), e[1])], 0)
            return (inner_nodes[id(e[0])], e[1])

        for node_ in [x for x in nodes if id(x) in region_ids]:
            inner_nodes[id(node_)] = _Node(
                node_.op, node_.name, dict(node_.attrs),
                [inner_entry(e) for e in node_.inputs])
        heads = [(inner_nodes[id(e[0])], e[1])
                 for e in consumed_outside[rid]]
        inner_sym = Symbol(heads)
        entry_slot[rid] = {_entry_key((e[0], e[1])): i
                           for i, e in enumerate(consumed_outside[rid])}
        # FMutateInputs through the boundary: if an inner op mutates one
        # of its inputs (BatchNorm moving stats) and that input is an
        # external entry, the fused node must mutate the same outer slot
        from .attribute import strip_annotations
        from .ops.registry import Attrs, get_op
        mutated_ext = []
        for node_ in regions[rid]:
            opdef = get_op(node_.op)
            for slot in opdef.mutate_slots(
                    Attrs(strip_annotations(node_.attrs))):
                e = node_.inputs[slot]
                if e in ext_entries:
                    i = ext_entries.index(e)
                    if i not in mutated_ext:
                        mutated_ext.append(i)
        attrs = {"__subgraph__": inner_sym.tojson(),
                 "__inputs__": json.dumps(input_names),
                 "__mutate__": json.dumps(mutated_ext),
                 "__num_outputs__": len(heads)}
        node = _Node(prop.subgraph_op,
                     f"subgraph{rid}_{regions[rid][0].name}",
                     attrs, [rebuilt_entry(e) for e in ext_entries])
        fused[rid] = node
        return node

    new_heads = [rebuilt_entry(e) for e in sym._heads]
    return Symbol(new_heads)


def apply_env_backend(sym):
    """Bind-time hook: MXNET_SUBGRAPH_BACKEND=<registered name> applies
    that property's partition pass (reference `build_subgraph.cc` env).
    An unregistered name raises — the reference CHECK-fails there too;
    silently skipping would hide typos."""
    backend = config.get_env("MXNET_SUBGRAPH_BACKEND", "")
    if backend:
        return partition(sym, get_subgraph_property(backend))
    return sym


# ---------------------------------------------------------------------------
# the fused op: executes its inner graph through the registry
# ---------------------------------------------------------------------------


def _register_subgraph_op():
    from .ops.registry import Attrs, register

    def _n_out(attrs: Attrs) -> int:
        return attrs.get_int("__num_outputs__", 1)

    def _mutate(attrs: Attrs):
        return tuple(json.loads(attrs.get_str("__mutate__", "[]")))

    @register("_subgraph_op", num_inputs=None, input_names=None,
              num_outputs=_n_out, mutate_inputs=_mutate,
              needs_rng=True, uses_train_mode=True, program_state=True)
    def _subgraph_op(attrs, generator, *inputs):
        """The inner graph's outputs, then the new values of the inputs
        it mutates, in ``__mutate__`` order (the executor writes them
        back to the outer aux variables)."""
        from .graph_compile import run_plan
        from .ops.control_flow import body_plan
        input_names = json.loads(attrs.get_str("__inputs__"))
        if len(inputs) != len(input_names):
            raise MXNetError(
                f"_subgraph_op: got {len(inputs)} inputs, graph wants "
                f"{len(input_names)}")
        meta = bool(inputs) and inputs[0].device.type == "meta"
        outs, aux = run_plan(body_plan(attrs, "__subgraph__", meta),
                             dict(zip(input_names, inputs)),
                             attrs.get_bool("__train", False), generator)
        extra = [aux.get(input_names[i], inputs[i])
                 for i in json.loads(attrs.get_str("__mutate__", "[]"))]
        outs = list(outs) + extra
        return tuple(outs) if len(outs) > 1 else outs[0]


_register_subgraph_op()


# ---------------------------------------------------------------------------
# a built-in property: elementwise-chain grouping (the MKLDNN-fuse role)
# ---------------------------------------------------------------------------

_ELEMWISE = {
    "Activation", "relu", "sigmoid", "tanh", "exp", "log", "negative",
    "abs", "square", "sqrt", "elemwise_add", "elemwise_sub",
    "elemwise_mul", "elemwise_div", "_plus_scalar", "_minus_scalar",
    "_mul_scalar", "_div_scalar", "clip", "LeakyReLU",
}


@register_subgraph_property("default")
class ElemwiseFuseProperty(SubgraphProperty):
    """Groups connected elementwise chains into one node (what the
    reference's MKLDNN property does for conv+relu+sum chains)."""

    def create_subgraph_selector(self):
        return OpNameSelector(_ELEMWISE)
