"""Model DAG: construction, topological sort, target sets, DOT export.

Counterpart of reference src/model/graph.jl (LightGraphs DiGraph +
gettargets/tsort/graph2dot).  Pure-Python structural metadata computed once at
model build; nothing here touches tensors.
"""

from __future__ import annotations

from collections import deque


class ModelGraph:
    """DAG over node names.  ``edges[u]`` = children of u (u is a source of
    each child), mirroring the reference's source->node edges
    (graph.jl:3-16)."""

    def __init__(self, nodes: dict, input_names: set[str]):
        self.nodes = nodes            # name -> Node (stochastic/logical)
        self.inputs = set(input_names)
        self.all_names = list(nodes.keys()) + sorted(self.inputs)
        self.children: dict[str, list[str]] = {n: [] for n in self.all_names}
        self.parents: dict[str, list[str]] = {n: [] for n in self.all_names}
        for name, node in nodes.items():
            for dep in node.deps:
                if dep not in self.children:
                    raise ValueError(f"node {name!r} depends on unknown node {dep!r}")
                self.children[dep].append(name)
                self.parents[name].append(dep)

    def tsort(self) -> list[str]:
        """Topological order over all names (reference graph.jl:105-108)."""
        indeg = {n: len(self.parents[n]) for n in self.all_names}
        q = deque(sorted(n for n in self.all_names if indeg[n] == 0))
        out = []
        while q:
            n = q.popleft()
            out.append(n)
            for c in self.children[n]:
                indeg[c] -= 1
                if indeg[c] == 0:
                    q.append(c)
        if len(out) != len(self.all_names):
            cyc = [n for n in self.all_names if indeg[n] > 0]
            raise ValueError(f"model graph contains a cycle through {cyc}")
        return out

    def gettargets(self, name: str) -> list[str]:
        """Dependent descendants of ``name``, pruned below the first
        stochastic node on each path (reference graph.jl:93-103): a node's
        Markov blanket downstream — the set whose log-densities change when
        ``name`` changes, holding other stochastics fixed."""
        seen = set()
        out = []
        stack = list(self.children[name])
        while stack:
            n = stack.pop()
            if n in seen or n in self.inputs:
                continue
            seen.add(n)
            out.append(n)
            if self.nodes[n].kind != "stochastic":
                stack.extend(self.children[n])
        order = {n: i for i, n in enumerate(self.tsort())}
        return sorted(out, key=order.__getitem__)

    def any_stochastic(self, name: str) -> bool:
        """True if any descendant is stochastic (reference graph.jl:81-91)."""
        stack = list(self.children[name])
        seen = set()
        while stack:
            n = stack.pop()
            if n in seen or n in self.inputs:
                continue
            seen.add(n)
            if self.nodes[n].kind == "stochastic":
                return True
            stack.extend(self.children[n])
        return False

    def to_dot(self, monitored: set[str] | None = None) -> str:
        """DOT export with the reference's shape coding (graph.jl:37-76):
        ellipse = stochastic, diamond = logical, box = input; gray = not
        monitored."""
        monitored = monitored or set()
        lines = ["digraph MambaModel {"]
        for n in self.all_names:
            if n in self.inputs:
                shape = "box"
            elif self.nodes[n].kind == "stochastic":
                shape = "ellipse"
            else:
                shape = "diamond"
            mon = n in monitored
            style = "" if mon else ', style=filled, fillcolor="gray85"'
            lines.append(f'  "{n}" [shape={shape}{style}];')
        for u, cs in self.children.items():
            for c in cs:
                lines.append(f'  "{u}" -> "{c}";')
        lines.append("}")
        return "\n".join(lines)
