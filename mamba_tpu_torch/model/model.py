"""Model: DAG of named nodes + sampling scheme.

Counterpart of reference src/model/model.jl.  The Model object is pure
structural metadata (nodes, graph, scheme); all numeric work happens in the
tensor functions produced by ``compile`` (compile.py).  The reference's
mutable Model (values + states + iteration counters, src/Mamba.jl:157-165)
splits here into Model (static) and chain-stacked state dicts (dynamic).
"""

from __future__ import annotations

import dataclasses

from .graph import ModelGraph
from .nodes import LogicalNode, Node, StochasticNode


class Model:
    """``Model(y=Stochastic(...), mu=Logical(...), ...)``.

    Any dependency name that is not itself a declared node is an *input*
    (data) node, mirroring the reference's keys(m, :input) semantics
    (model.jl:105-112).
    """

    def __init__(self, samplers=None, **nodes):
        self.nodes: dict[str, Node] = {}
        for name, node in nodes.items():
            if not isinstance(node, Node):
                raise TypeError(f"{name} is not a Stochastic/Logical node")
            self.nodes[name] = dataclasses.replace(node, name=name)
        declared = set(self.nodes)
        inputs = set()
        for node in self.nodes.values():
            inputs.update(d for d in node.deps if d not in declared)
        self.input_names = inputs
        self.graph = ModelGraph(self.nodes, inputs)
        self.topo = [n for n in self.graph.tsort() if n in self.nodes]
        self.samplers = list(samplers) if samplers else []

    # -- scheme ---------------------------------------------------------
    def set_samplers(self, scheme):
        """Assign the block-sampling scheme (reference ``setsamplers!``,
        initialization.jl:42-48).  Returns self for chaining."""
        self.samplers = list(scheme)
        for s in self.samplers:
            unknown = [p for p in s.params if p not in self.nodes]
            if unknown:
                raise ValueError(f"sampler block references unknown nodes {unknown}")
        return self

    setsamplers = set_samplers  # reference-style alias

    # -- queries (reference model.jl:58-205 ``keys`` dispatch) ----------
    def keys(self, kind: str = "all", *args) -> list[str]:
        if kind == "all":
            return list(self.nodes) + sorted(self.input_names)
        if kind in ("input", "independent"):
            return sorted(self.input_names)
        if kind == "dependent":
            return list(self.topo)
        if kind == "stochastic":
            return [n for n in self.topo if isinstance(self.nodes[n], StochasticNode)]
        if kind == "logical":
            return [n for n in self.topo if isinstance(self.nodes[n], LogicalNode)]
        if kind == "monitor":
            return [n for n in self.topo if self.nodes[n].monitored]
        if kind == "block":
            block = args[0] if args else 0
            if block == 0:
                out = []
                for s in self.samplers:
                    out.extend(p for p in s.params if p not in out)
                return out
            return list(self.samplers[block - 1].params)
        if kind == "sampled":
            sampled = set()
            for s in self.samplers:
                sampled.update(s.params)
            return [n for n in self.keys("stochastic") if n in sampled]
        if kind == "observed" or kind == "output":
            sampled = set(self.keys("sampled"))
            return [n for n in self.keys("stochastic") if n not in sampled]
        if kind == "assigned":
            # reference keys_assigned (model.jl:74-90): inputs always hold
            # values; dependent nodes only once inits exist.  Values live in
            # state dicts here (functional design), so the state is passed
            # explicitly: keys("assigned") -> inputs only; keys("assigned",
            # state) -> inputs + stochastics present in the state + logicals
            # (derivable) when every stochastic is present.
            out = sorted(self.input_names)
            if args and args[0]:
                state = args[0]
                stoch = self.keys("stochastic")
                present = [n for n in stoch if n in state]
                out += present
                if len(present) == len(stoch):
                    out += self.keys("logical")
            return out
        if kind == "source":
            name = args[0]
            return list(self.graph.parents[name])
        if kind == "target":
            names = args[0] if args else self.topo
            if isinstance(names, str):
                names = [names]
            out = []
            for n in names:
                for t in self.graph.gettargets(n):
                    if t not in out:
                        out.append(t)
            order = {n: i for i, n in enumerate(self.graph.tsort())}
            return sorted(out, key=order.__getitem__)
        raise ValueError(f"unknown node query kind {kind!r}")

    # -- graph export ---------------------------------------------------
    def graph2dot(self) -> str:
        """DOT representation (reference graph.jl:37-76)."""
        return self.graph.to_dot(monitored=set(self.keys("monitor")))

    def draw(self, filename: str | None = None) -> str:
        dot = self.graph2dot()
        if filename:
            with open(filename, "w") as f:
                f.write(dot)
        return dot

    def __repr__(self):
        stoch = self.keys("stochastic")
        logical = self.keys("logical")
        return (f"Model(stochastic={stoch}, logical={logical}, "
                f"inputs={sorted(self.input_names)}, blocks={len(self.samplers)})")
