"""Topology configuration — the Python analog of Beehive's XML tooling
(paper §4.7).

A TopologyConfig declares the mesh dimensions, every tile endpoint (name,
coordinates, kind), the next-hop routing entries for each tile, and the set
of message chains the stack supports.  From it we:

  * validate coordinates (unique, in-bounds — the paper's soundness checks),
  * auto-generate empty router-only tiles to keep the mesh rectangular,
  * generate the "top-level wiring" (router adjacency — the paper emits
    SystemVerilog; we emit the adjacency structure the runtime + analysis
    consume),
  * enumerate all possible message chains for compile-time deadlock
    analysis (core/deadlock.py),
  * count configuration LoC for the flexibility benchmark (paper Table 1).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.noc import Coord, chain_channels, mesh_coords

# route-match spaces a tile can use to pick the next hop (paper §4.2: CAMs
# keyed on header fields, runtime-rewritable).  "tile" addresses a
# management-NoC endpoint by its target index (paper §3.6).  "rpc_msg"
# dispatches on the RPC frame's msg_type — app tiles are addressed by the
# request kind, not just the UDP port (the direct-attached serving path).
MATCH_SPACES = ("ethertype", "ip_proto", "udp_port", "tcp_port", "rpc_msg",
                "flow_hash", "rr", "const", "vip", "tile")


@dataclasses.dataclass
class RouteEntry:
    match: str                      # one of MATCH_SPACES
    key: Optional[int]              # None = wildcard/default
    next_tile: str


@dataclasses.dataclass
class TileDecl:
    name: str
    kind: str                       # e.g. "eth_rx", "udp_tx", "app:echo"
    x: int
    y: int
    noc: str = "data"               # "data" | "ctrl"  (paper §3.6)
    routes: List[RouteEntry] = dataclasses.field(default_factory=list)
    # per-tile configuration knobs (the paper's per-element XML attributes;
    # e.g. cc_policy on tcp_rx) — read by the tile's init hook at compile
    params: Dict[str, object] = dataclasses.field(default_factory=dict)

    @property
    def coord(self) -> Coord:
        return (self.x, self.y)


@dataclasses.dataclass
class TopologyConfig:
    name: str
    dim_x: int
    dim_y: int
    tiles: List[TileDecl] = dataclasses.field(default_factory=list)
    chains: List[List[str]] = dataclasses.field(default_factory=list)
    # replica groups registered by core.scaleout.replicate: group name ->
    # {"members": [...], "policy": ..., "kind": ..., "base_port": ...,
    #  "noc": ...}.  A group name is a valid route *target* (the upstream
    # CAM keeps its pre-replication entry); the compiler lowers the group
    # to one RSS dispatch stage.  Group names are NOT tiles: tile()/
    # has_tile() stay strict, has_node()/members_of() resolve both.
    replica_groups: Dict[str, Dict] = dataclasses.field(default_factory=dict)

    # ---- construction helpers (the "XML" the user writes) -----------------
    def add_tile(self, name: str, kind: str, x: int, y: int,
                 noc: str = "data", params: Optional[Dict] = None) -> TileDecl:
        t = TileDecl(name, kind, x, y, noc, params=dict(params or {}))
        self.tiles.append(t)
        return t

    def add_route(self, tile: str, match: str, key: Optional[int],
                  next_tile: str) -> None:
        assert match in MATCH_SPACES, match
        for nm in self.members_of(tile):
            self.tile(nm).routes.append(RouteEntry(match, key, next_tile))

    def add_chain(self, *names: str) -> None:
        # a replica-group name in a chain expands to one chain per member
        # (same treatment replicate() applies to pre-existing chains)
        expanded: List[List[str]] = [[]]
        for n in names:
            members = self.members_of(n)
            expanded = [c + [m] for c in expanded for m in members]
        self.chains.extend(expanded)

    def insert_on_path(self, name: str, kind: str, x: int, y: int,
                       src: str, dst: str, noc: str = "data",
                       match: Optional[str] = None,
                       key: Optional[int] = None) -> TileDecl:
        """Insert a tile between `src` and `dst` purely as a config edit
        (the paper's Table-1 flexibility story): every route on `src` that
        pointed at `dst` is re-aimed at the new tile, the new tile gets a
        const route on to `dst`, and declared chains passing src->dst are
        re-threaded through the new tile so the deadlock analysis stays
        honest.  Neither endpoint's tile function is touched.

        Pass `match`/`key` to rewrite the re-aimed routes' match condition
        — an encapsulation tile classifies on the *outer* header (e.g.
        ip_proto=4 for IP-in-IP), not on the key the original route used."""
        t = self.add_tile(name, kind, x, y, noc)
        src_names = set(self.members_of(src))
        dst_names = {dst} | set(self.members_of(dst))
        for nm in src_names:
            for r in self.tile(nm).routes:
                if r.next_tile in dst_names:
                    r.next_tile = name
                    if match is not None:
                        assert match in MATCH_SPACES, match
                        r.match, r.key = match, key
        t.routes.append(RouteEntry("const", None, dst))
        for c in self.chains:
            for i in range(len(c) - 1):
                if c[i] in src_names and c[i + 1] in dst_names:
                    c.insert(i + 1, name)
                    break
        return t

    # ---- lookups -----------------------------------------------------------
    def tile(self, name: str) -> TileDecl:
        for t in self.tiles:
            if t.name == name:
                return t
        raise KeyError(f"no tile named {name!r}")

    def has_tile(self, name: str) -> bool:
        return any(t.name == name for t in self.tiles)

    def is_replica_group(self, name: str) -> bool:
        return name in self.replica_groups

    def has_node(self, name: str) -> bool:
        """True for a declared tile OR a registered replica group."""
        return self.has_tile(name) or name in self.replica_groups

    def members_of(self, name: str) -> List[str]:
        """A replica group's member tile names; [name] for a plain tile."""
        g = self.replica_groups.get(name)
        return list(g["members"]) if g is not None else [name]

    def routes_of(self, name: str) -> List[RouteEntry]:
        """A tile's routes, or a replica group's (the members carry
        identical clones — the first member's list is the group's)."""
        return self.tile(self.members_of(name)[0]).routes

    def coords_of(self, chain: Sequence[str]) -> List[Coord]:
        return [self.tile(n).coord for n in chain]

    def tiles_on(self, noc: str) -> List[TileDecl]:
        return [t for t in self.tiles if t.noc == noc]

    # ---- validation (paper: coordinate soundness checks) -------------------
    def validate(self) -> List[str]:
        errors: List[str] = []
        seen: Dict[Tuple[str, Coord], str] = {}
        names = set()
        for t in self.tiles:
            if t.name in names:
                errors.append(f"duplicate tile name {t.name!r}")
            names.add(t.name)
            if not (0 <= t.x < self.dim_x and 0 <= t.y < self.dim_y):
                errors.append(f"tile {t.name!r} at {t.coord} outside "
                              f"{self.dim_x}x{self.dim_y} mesh")
            key = (t.noc, t.coord)
            if key in seen:
                errors.append(f"tiles {seen[key]!r} and {t.name!r} share "
                              f"coordinate {t.coord} on noc {t.noc!r}")
            seen[key] = t.name
        for c in self.chains:
            for n in c:
                if n not in names:
                    errors.append(f"chain {c} references unknown tile {n!r}")
        noc_of = {t.name: t.noc for t in self.tiles}
        for gname, g in self.replica_groups.items():
            if gname in names:
                errors.append(f"replica group {gname!r} collides with a "
                              f"declared tile name")
            if not g.get("members"):
                errors.append(f"replica group {gname!r} has no members")
            for m in g.get("members", []):
                if m not in names:
                    errors.append(f"replica group {gname!r} member {m!r} "
                                  f"is not a declared tile")
            # a route aimed at the group resolves to its members' noc
            noc_of[gname] = g.get("noc", "data")
        for t in self.tiles:
            for r in t.routes:
                if r.next_tile not in noc_of:
                    errors.append(f"route on {t.name!r} -> unknown tile "
                                  f"{r.next_tile!r}")
                elif noc_of[r.next_tile] != t.noc:
                    # paper §3.6: management traffic runs on its own NoC so
                    # it never enters a dataplane chain's dependency graph
                    errors.append(
                        f"route on {t.name!r} (noc {t.noc!r}) crosses into "
                        f"noc {noc_of[r.next_tile]!r} tile "
                        f"{r.next_tile!r}: control and data traffic must "
                        f"not share chains")
        for c in self.chains:
            nocs = sorted({noc_of[n] for n in c if n in noc_of})
            if len(nocs) > 1:
                errors.append(f"chain {c} mixes nocs {nocs}")
        return errors

    # ---- generation ("top-level wiring") ------------------------------------
    def filled_coords(self, noc: str = "data") -> List[Coord]:
        """Rectangular mesh = declared tiles + auto-generated empty routers
        (paper: 'automatically generate empty tiles that just contain a
        router')."""
        used = {t.coord for t in self.tiles_on(noc)}
        return [c for c in mesh_coords(self.dim_x, self.dim_y)
                if c not in used]

    def wiring(self, noc: str = "data") -> List[Tuple[Coord, Coord]]:
        """Full-duplex router adjacency for the rectangular mesh."""
        wires = []
        for (x, y) in mesh_coords(self.dim_x, self.dim_y):
            if x + 1 < self.dim_x:
                wires.append(((x, y), (x + 1, y)))
            if y + 1 < self.dim_y:
                wires.append(((x, y), (x, y + 1)))
        return wires

    def chain_channel_lists(self):
        """(chain, ordered channel list) for the deadlock analysis."""
        return [(c, chain_channels(self.coords_of(c))) for c in self.chains]

    # ---- (de)serialization + LoC accounting ---------------------------------
    def to_dict(self) -> dict:
        return {
            "name": self.name, "dim_x": self.dim_x, "dim_y": self.dim_y,
            "tiles": [{
                "name": t.name, "kind": t.kind, "x": t.x, "y": t.y,
                "noc": t.noc,
                **({"params": dict(t.params)} if t.params else {}),
                "routes": [dataclasses.asdict(r) for r in t.routes],
            } for t in self.tiles],
            "chains": self.chains,
            **({"replica_groups": {g: dict(v) for g, v
                                   in self.replica_groups.items()}}
               if self.replica_groups else {}),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "TopologyConfig":
        topo = cls(d["name"], d["dim_x"], d["dim_y"])
        for td in d["tiles"]:
            t = topo.add_tile(td["name"], td["kind"], td["x"], td["y"],
                              td.get("noc", "data"), td.get("params"))
            for r in td.get("routes", []):
                t.routes.append(RouteEntry(r["match"], r["key"],
                                           r["next_tile"]))
        topo.chains = [list(c) for c in d.get("chains", [])]
        topo.replica_groups = {g: dict(v) for g, v
                               in d.get("replica_groups", {}).items()}
        return topo

    def config_loc(self, tile_names: Sequence[str]) -> int:
        """Lines of serialized configuration needed to declare the given
        tiles + their route entries — the paper's Table 1 flexibility
        metric."""
        d = self.to_dict()
        lines = 0
        for td in d["tiles"]:
            if td["name"] in tile_names:
                lines += len(json.dumps(td, indent=1).splitlines())
        # destination entries added on *other* tiles
        for td in d["tiles"]:
            if td["name"] in tile_names:
                continue
            for r in td["routes"]:
                if r["next_tile"] in tile_names:
                    lines += 1
        return lines
