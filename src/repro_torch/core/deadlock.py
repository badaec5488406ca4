"""Compile-time message-deadlock analysis (paper §3.5).

Model: wormhole switching with dimension-ordered routing.  Routing-level
deadlock is impossible under DOR (Dally & Seitz); *message-level* deadlock
remains because a tile chain (Eth -> IP -> UDP -> App) holds NoC channels
while acquiring more.  We build the channel-dependency graph: for every
declared chain, the ordered list of channels it traverses contributes edges
c_i -> c_{i+1}; additionally every chain must never re-acquire a channel it
already holds (self-deadlock, paper Fig. 5a).  Any cycle in the union graph
is a potential deadlock; the designer must re-place tiles (Fig. 5b) or
duplicate them (IP-in-IP) until the graph is acyclic.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import networkx as nx

from repro_torch.core.noc import Channel, chain_channels
from repro_torch.core.topology import TopologyConfig


@dataclasses.dataclass
class DeadlockReport:
    ok: bool
    self_conflicts: List[Tuple[List[str], Channel]]
    cycles: List[List[Channel]]

    def summary(self) -> str:
        if self.ok:
            return "deadlock-free: channel dependency graph is acyclic"
        lines = []
        for chain, ch in self.self_conflicts:
            lines.append(f"chain {'->'.join(chain)} re-acquires channel {ch}")
        for cyc in self.cycles:
            lines.append("cycle: " + " -> ".join(map(repr, cyc)))
        return "\n".join(lines)


def analyze(topo: TopologyConfig, noc: str = "data") -> DeadlockReport:
    """Per-NoC analysis: each NoC has its own physical channels (paper
    §3.6 — the management NoC is a separate, narrower mesh), so only the
    chains whose tiles live on `noc` contribute to its dependency graph.
    Control chains can therefore never deadlock a dataplane chain, and
    vice versa."""
    errors = topo.validate()
    if errors:
        raise ValueError("invalid topology:\n" + "\n".join(errors))

    noc_of = {t.name: t.noc for t in topo.tiles}
    g = nx.DiGraph()
    self_conflicts = []
    for chain, channels in topo.chain_channel_lists():
        if any(noc_of.get(n, "data") != noc for n in chain):
            continue
        seen = set()
        for ch in channels:
            if ch in seen:
                self_conflicts.append((chain, ch))
            seen.add(ch)
        for a, b in zip(channels, channels[1:]):
            g.add_edge(a, b)

    cycles = list(nx.simple_cycles(g))
    ok = not cycles and not self_conflicts
    return DeadlockReport(ok=ok, self_conflicts=self_conflicts,
                          cycles=[c for c in cycles])


def assert_deadlock_free(topo: TopologyConfig) -> None:
    """Every NoC in the topology must be independently deadlock-free."""
    for noc in sorted({t.noc for t in topo.tiles}):
        rep = analyze(topo, noc=noc)
        if not rep.ok:
            raise RuntimeError(
                f"topology {topo.name!r} can deadlock on noc {noc!r}:\n"
                f"{rep.summary()}\n"
                "Re-place tiles so chains acquire channels in order, or "
                "duplicate tiles (paper §3.5).")
