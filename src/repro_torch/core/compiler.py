"""Topology-compiled stack executor.

The paper's stacks are *configurations*: protocol and application elements
are tiles over the NoC, and the processing graph is whatever the declared
routes say.  :class:`StackCompiler` takes a validated
:class:`TopologyConfig` and emits one batch pipeline of PyTorch calls:

  1. tiles are grouped into execution nodes (app replicas — tiles whose
     kind is ``app:<name>`` — collapse into one dispatch group);
  2. the route entries define a DAG over nodes, ordered topologically
     (stable in declaration order);
  3. each node's kind is bound to a *tile function* from the registry
     (``register_tile``); per-tile state threads through one state dict;
  4. each packet's path is predicated by the route-match fields: a packet
     "arrives" at a node iff some in-edge's source succeeded on it AND the
     route key matches (the live CAM lookup for keyed routes);
  5. every node gets a row in the stacked counter log and the drop-reason
     table, written once per batch at egress.

Tile function contract::

    @register_tile("my_kind", init=my_init)          # my_init(ctx) -> dict
    def my_tile(state, carrier, pred, ctx):
        ...
        return state, carrier, ok        # ok: (B,) bool or None (all pass)

Not ported yet, and refused rather than run wrong: replica groups
(``topology.replica_groups``, ROADMAP queue 1 item 8), the observability
taps (``with_obs=True``, item 9) and the management plane's post-batch
commit (item 7).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core import deadlock, routing, telemetry
from repro_torch.core.noc import chain_latency_cycles
from repro_torch.core.topology import RouteEntry, TileDecl, TopologyConfig
from repro_torch.obs import reasons
from repro_torch.tree import tree_map

# reference payload for the per-tile NoC latency estimate (the paper's
# latency measurement uses 64-byte messages)
REF_PAYLOAD_BYTES = 64

OBS_NOT_PORTED = ("with_obs=True: the flight recorder, series and "
                  "postcard/watchdog taps are not ported yet (ROADMAP "
                  "queue 1 item 9, observability)")


class CompileError(ValueError):
    pass


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another.  Raises when CUDA is asked for (or defaulted to) and
    absent — there is no silent fallback to the CPU."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to "
                           "run the plain versions on the CPU")
    # resolve "cuda" to "cuda:<current>", the device tensors report
    return torch.empty(0, device=dev).device


# ---------------------------------------------------------------------------
# tile-function registry


@dataclasses.dataclass
class TileSpec:
    fn: Callable
    init: Optional[Callable] = None     # (ctx) -> state-dict contribution
    alive: bool = False                 # RX parse tile: pred & ok feeds the
                                        # chain's "alive" mask
    rewrites: Tuple[str, ...] = ()      # meta fields this kind re-parses
                                        # (pruning soundness)


TILE_REGISTRY: Dict[str, TileSpec] = {}


def register_tile(kind: str, init: Optional[Callable] = None,
                  alive: bool = False, rewrites: Tuple[str, ...] = ()):
    """Decorator binding a tile kind to its tile function (see the module
    docstring for the contract and the reference for the flags)."""
    def deco(fn):
        TILE_REGISTRY[kind] = TileSpec(fn=fn, init=init, alive=alive,
                                       rewrites=tuple(rewrites))
        return fn
    return deco


def resolve_kind(kind: str) -> TileSpec:
    """Exact kind first, then the family before ':' (app:echo -> app)."""
    if kind in TILE_REGISTRY:
        return TILE_REGISTRY[kind]
    fam = kind.split(":", 1)[0]
    if fam in TILE_REGISTRY:
        return TILE_REGISTRY[fam]
    raise CompileError(f"no tile function registered for kind {kind!r} "
                       f"(known: {sorted(TILE_REGISTRY)})")


@dataclasses.dataclass
class TileContext:
    name: str                   # node name (tile name / app group name)
    kind: str
    members: List[TileDecl]     # 1 entry for plain tiles, N for app groups
    binding: Any                # e.g. the AppDecl for app groups
    options: Dict[str, Any]     # compiler-level options (local_ip, ...)
    lat_cycles: int             # NoC latency estimate from the ingress
    index: int                  # execution position
    pipe: Any = None            # pipeline-level meta (order/groups/tables)


# ---------------------------------------------------------------------------
# route-match predicates (the CAM lookup, paper §4.2)

_MATCH_FIELD = {"ethertype": "ethertype", "ip_proto": "ip_proto",
                "udp_port": "dst_port", "tcp_port": "dst_port",
                "rpc_msg": "msg_type"}


def _match_pred(route: RouteEntry, carrier, n, device):
    """Per-packet bool for one route entry, evaluated on the live meta."""
    field = _MATCH_FIELD.get(route.match)
    if field is None or route.key is None:     # const / rr / flow_hash / vip
        return torch.ones((n,), dtype=torch.bool, device=device)
    return carrier["meta"][field] == route.key


# ---------------------------------------------------------------------------
# nodes + compiler


@dataclasses.dataclass
class _Node:
    name: str
    kind: str
    members: List[TileDecl]
    index: int


def deep_merge(dst: dict, src: dict) -> dict:
    for k, v in src.items():
        if k in dst and isinstance(dst[k], dict) and isinstance(v, dict):
            deep_merge(dst[k], v)
        else:
            dst[k] = v
    return dst


class StackCompiler:
    """Compiles a TopologyConfig into executable pipelines.

    bindings: extra per-node configuration, keyed by node name (the app
    group name for ``app:*`` tiles).  options: stack-level settings read
    by tile init functions (``local_ip``, ...).
    """

    def __init__(self, topo: TopologyConfig,
                 bindings: Optional[Dict[str, Any]] = None,
                 options: Optional[Dict[str, Any]] = None,
                 check_deadlock: bool = True,
                 noc: str = "data"):
        errs = topo.validate()
        if errs:
            raise CompileError("invalid topology:\n" + "\n".join(errs))
        if check_deadlock:
            deadlock.assert_deadlock_free(topo)
        if topo.replica_groups:
            raise CompileError(
                f"replica groups {sorted(topo.replica_groups)} are not "
                f"ported yet (ROADMAP queue 1 item 8, scale-out)")
        self.topo = topo
        self.bindings = bindings or {}
        self.options = options or {}

        # ---- group tiles into nodes -----------------------------------
        self.nodes: Dict[str, _Node] = {}
        self._node_of: Dict[str, str] = {}
        for t in topo.tiles_on(noc):
            nname = t.kind.split(":", 1)[1] if t.kind.startswith("app:") \
                else t.name
            node = self.nodes.get(nname)
            if node is None:
                self.nodes[nname] = _Node(nname, t.kind, [t],
                                          len(self.nodes))
            else:
                if node.kind != t.kind:
                    raise CompileError(
                        f"group {nname!r} mixes kinds {node.kind!r} and "
                        f"{t.kind!r}")
                node.members.append(t)
            self._node_of[t.name] = nname

        # ---- route edges between nodes (app replicas carry identical
        # route clones: dedupe so the group gets each logical edge once) -
        self.edges: List[Tuple[str, str, RouteEntry]] = []
        seen_edges = set()
        for t in topo.tiles_on(noc):
            for r in t.routes:
                src = self._node_of.get(t.name)
                dst = self._node_of.get(r.next_tile)
                if src is None or dst is None or src == dst:
                    continue                       # intra-group / other noc
                ek = (src, dst, r.match, r.key)
                if ek in seen_edges:
                    continue
                seen_edges.add(ek)
                self.edges.append((src, dst, r))

    # ---- ordering --------------------------------------------------------
    def _reachable(self, ingress: str) -> List[str]:
        seen = {ingress}
        frontier = [ingress]
        while frontier:
            cur = frontier.pop()
            for s, d, _ in self.edges:
                if s == cur and d not in seen:
                    seen.add(d)
                    frontier.append(d)
        return sorted(seen, key=lambda n: self.nodes[n].index)

    def _topo_order(self, names: Sequence[str]) -> List[str]:
        names = set(names)
        indeg = {n: 0 for n in names}
        for s, d, _ in self.edges:
            if s in names and d in names:
                indeg[d] += 1
        order: List[str] = []
        ready = sorted([n for n, d in indeg.items() if d == 0],
                       key=lambda n: self.nodes[n].index)
        while ready:
            cur = ready.pop(0)
            order.append(cur)
            for s, d, _ in self.edges:
                if s == cur and d in indeg:
                    indeg[d] -= 1
                    if indeg[d] == 0:
                        ready.append(d)
            ready.sort(key=lambda n: self.nodes[n].index)
        if len(order) != len(names):
            cyc = sorted(names - set(order))
            raise CompileError(f"route graph has a cycle through {cyc}")
        return order

    def _latency_estimates(self, ingress: str,
                           names: Sequence[str]) -> Dict[str, int]:
        """Compile-time NoC latency (cycles) from the ingress tile to each
        node, along the shortest route-graph path (BFS)."""
        parent: Dict[str, Optional[str]] = {ingress: None}
        frontier = [ingress]
        while frontier:
            nxt = []
            for cur in frontier:
                for s, d, _ in self.edges:
                    if s == cur and d not in parent:
                        parent[d] = cur
                        nxt.append(d)
            frontier = nxt
        out = {}
        for n in names:
            path, cur = [], n
            while cur is not None:
                path.append(cur)
                cur = parent.get(cur)
            coords = [self.nodes[p].members[0].coord for p in reversed(path)]
            out[n] = chain_latency_cycles(coords, REF_PAYLOAD_BYTES)
        return out

    # ---- dead-stage pruning ----------------------------------------------
    # Route keys on ethertype / ip_proto are structural: an edge keyed on a
    # value that contradicts what every upstream path committed to can
    # never fire, and a node whose in-edges are all dead is pruned.  Port-
    # and msg-keyed routes are runtime-rewritable CAMs and never pruned.
    _STATIC_MATCH = ("ethertype", "ip_proto")

    def _prune_dead(self, start: str,
                    order: Sequence[str]) -> Tuple[List[str], List[str]]:
        """Constraint propagation over the route DAG (see the reference's
        ``StackCompiler._prune_dead`` for the soundness argument): a field
        rewritten by more than one compiled node is exempt."""
        def join(a, b):
            return {f: a[f] | b[f] for f in set(a) & set(b)}

        writers: Dict[str, int] = {}
        for n in order:
            for f in resolve_kind(self.nodes[n].kind).rewrites:
                writers[f] = writers.get(f, 0) + 1
        static = tuple(f for f in self._STATIC_MATCH
                       if writers.get(f, 0) <= 1)

        names = set(order)
        feasible: Dict[str, Dict[str, set]] = {start: {}}
        for n in order:
            if n == start:
                continue
            merged = None
            for s, d, r in self.edges:
                if d != n or s not in names or s not in feasible:
                    continue
                cs = feasible[s]
                if r.match in static and r.key is not None:
                    vals = cs.get(r.match)
                    if vals is not None and r.key not in vals:
                        continue               # edge contradicts upstream
                    cs = dict(cs)
                    cs[r.match] = {r.key}
                merged = cs if merged is None else join(merged, cs)
            if merged is not None:
                feasible[n] = merged
        return ([n for n in order if n in feasible],
                [n for n in order if n not in feasible])

    def _is_trunk(self, ingress: str, names, node: str) -> bool:
        """True when every packet path from the ingress passes through
        `node` (route-DAG post-dominance).  A trunk alive-tile gates the
        whole stack; a branch alive-tile only judges its own packets."""
        names = set(names)
        sinks = {n for n in names
                 if not any(s == n and d in names for s, d, _ in self.edges)}
        seen = {ingress} if ingress != node else set()
        frontier = list(seen)
        while frontier:
            cur = frontier.pop()
            for s, d, _ in self.edges:
                if s == cur and d in names and d != node and d not in seen:
                    seen.add(d)
                    frontier.append(d)
        return not (seen & sinks)

    # ---- compilation -----------------------------------------------------
    def compile(self, ingress: str) -> "CompiledPipeline":
        """Pipeline over every node reachable from `ingress` (a tile name)."""
        if ingress not in self._node_of:
            raise CompileError(f"unknown ingress tile {ingress!r}")
        start = self._node_of[ingress]
        names = self._reachable(start)
        order = self._topo_order(names)
        order, pruned = self._prune_dead(start, order)
        names = list(order)
        lats = self._latency_estimates(start, names)
        index_of = {n: i for i, n in enumerate(order)}

        # runtime route tables (the paper's runtime-rewritable CAMs): every
        # keyed route entry becomes a slot in a per-(source, match-space)
        # table held in state.  Values are execution-node indices.
        table_entries: Dict[str, List[Tuple[int, int]]] = {}
        for s, d, r in self.edges:
            if (s in index_of and d in index_of and r.key is not None
                    and r.match in _MATCH_FIELD):
                table_entries.setdefault(f"{s}:{r.match}", []).append(
                    (r.key, index_of[d]))

        pipe_meta = {
            "order": order,
            "groups": [n for n in order
                       if self.nodes[n].kind.startswith("app:")],
            "tables": sorted(table_entries),
        }

        stages = []
        for i, n in enumerate(order):
            node = self.nodes[n]
            spec = resolve_kind(node.kind)
            binding = self.bindings.get(n, self.bindings.get(node.kind))
            ctx = TileContext(name=n, kind=node.kind, members=node.members,
                              binding=binding, options=self.options,
                              lat_cycles=lats[n], index=i, pipe=pipe_meta)
            in_edges = [(s, r) for s, d, r in self.edges
                        if d == n and s in index_of]
            trunk = spec.alive and self._is_trunk(start, names, n)
            stages.append((node, spec, ctx, in_edges, trunk))
        return CompiledPipeline(start, stages, table_entries, pipe_meta,
                                pruned=pruned)


class CompiledPipeline:
    """One executor: run(state, carrier) -> (state, carrier) per batch, or
    run_stream(state, payloads, lengths) for N batches in a loop that
    never synchronizes with the host."""

    # carrier keys worth stacking out of a streamed run (whichever exist)
    STREAM_OUT_KEYS = ("tx_payload", "tx_len", "alive", "info")

    def __init__(self, ingress: str, stages, table_entries=None,
                 pipe_meta=None, pruned=None):
        self.ingress = ingress
        self.stages = stages
        self.table_entries = table_entries or {}
        self.pruned = list(pruned or [])
        self.pipe_meta = pipe_meta or {"order": self.order, "groups": [],
                                       "tables": []}
        self._index = {node.name: i
                       for i, (node, *_) in enumerate(self.stages)}
        self._lat = [ctx.lat_cycles for _, _, ctx, *_ in self.stages]
        # static per-node columns of the counter block, one copy per device
        # (made by init_state, so a run never copies from the host)
        self._columns: Dict[torch.device, Tuple[torch.Tensor, ...]] = {}

    @property
    def order(self) -> List[str]:
        return [node.name for node, *_ in self.stages]

    def summary(self) -> str:
        lines = []
        for node, _, ctx, in_edges, _trunk in self.stages:
            srcs = ", ".join(f"{s}[{r.match}"
                             f"{'' if r.key is None else '=' + hex(r.key)}]"
                             for s, r in in_edges) or "(ingress)"
            lines.append(f"{ctx.index:2d} {node.name:<12} kind={node.kind:<12}"
                         f" lat~{ctx.lat_cycles}cyc <- {srcs}")
        return "\n".join(lines)

    def _node_columns(self, device: torch.device):
        if device not in self._columns:
            self._columns[device] = (
                torch.tensor(self._lat, dtype=torch.int32, device=device),
                torch.arange(len(self.stages), dtype=torch.int32,
                             device=device))
        return self._columns[device]

    # ---- state -----------------------------------------------------------
    def init_state(self, with_telemetry: bool = True,
                   log_entries: int = telemetry.PIPE_LOG_ENTRIES,
                   with_obs: bool = False, device=None) -> Dict[str, Any]:
        """Fresh state on ``device`` (default: the card, see
        :func:`resolve_device`).  No tensor is shared with another state or
        with a tile's template."""
        if with_obs:
            raise NotImplementedError(OBS_NOT_PORTED)
        device = resolve_device(device)
        st: Dict[str, Any] = {}
        for node, spec, ctx, *_ in self.stages:
            if spec.init is not None:
                deep_merge(st, spec.init(ctx))
        if self.table_entries:
            deep_merge(st, {"routes": {
                t: routing.make_table(ents)
                for t, ents in self.table_entries.items()}})
        if with_telemetry:
            deep_merge(st, {"telemetry": {
                "step": torch.zeros((), dtype=torch.int32),
                "nodes": telemetry.make_node_log(len(self.stages),
                                                 log_entries),
                "logs": {},
                "drops": telemetry.make_drop_table(len(self.stages),
                                                   reasons.NUM_REASONS),
            }})
        self._node_columns(device)
        return tree_map(lambda t: t.to(device), st)

    # ---- telemetry access ------------------------------------------------
    def node_log(self, state, name: str) -> telemetry.RingLog:
        """One node's counter rows out of the stacked node log."""
        return telemetry.node_view(state["telemetry"]["nodes"],
                                   self._index[name])

    def node_logs(self, state) -> Dict[str, telemetry.RingLog]:
        return {n: self.node_log(state, n) for n in self.order}

    # ---- execution -------------------------------------------------------
    def run(self, state: Dict[str, Any], carrier: Dict[str, Any],
            with_telemetry: bool = True):
        """One batch through the chain.  Nothing here reads a tensor back
        to the host: every per-packet decision is a mask."""
        state = dict(state)
        carrier = dict(carrier)
        carrier.setdefault("meta", {})
        carrier.setdefault("info", {})
        n = carrier["payload"].shape[0]
        device = carrier["payload"].device

        telem = state.get("telemetry") if with_telemetry else None
        if telem is not None:
            src = state["telemetry"]
            telem = {"step": src["step"] + 1, "logs": dict(src["logs"])}
            for k in ("nodes", "drops"):
                if k in src:
                    telem[k] = src[k]
            state["telemetry"] = telem
        count_nodes = telem is not None and "nodes" in telem
        count_drops = telem is not None and "drops" in telem

        routes_rt = state.get("routes")
        pkts_in: List[torch.Tensor] = []
        drops: List[torch.Tensor] = []
        drop_blocks: List[torch.Tensor] = []
        zero_reason = torch.zeros((n,), dtype=torch.int32, device=device)
        ok_of: Dict[str, torch.Tensor] = {}
        for node, spec, ctx, in_edges, trunk in self.stages:
            if not in_edges:                       # ingress / chain root
                pred = torch.ones((n,), dtype=torch.bool, device=device)
            else:
                pred = torch.zeros((n,), dtype=torch.bool, device=device)
                for src, route in in_edges:
                    tname = f"{src}:{route.match}"
                    if (route.key is not None and route.match in _MATCH_FIELD
                            and routes_rt is not None
                            and tname in routes_rt):
                        # live CAM lookup: the control plane can rewrite
                        # this table between batches (paper §4.2)
                        field = carrier["meta"][_MATCH_FIELD[route.match]]
                        nxt = routes_rt[tname].lookup(field.to(torch.int32))
                        hit = nxt == self._index[node.name]
                    else:
                        hit = _match_pred(route, carrier, n, device)
                    pred = pred | (ok_of[src] & hit)
            carrier = dict(carrier)
            carrier["drop_reason"] = zero_reason   # tiles overwrite per row
            state, carrier, ok = spec.fn(state, carrier, pred, ctx)
            ok_of[node.name] = pred & ok if ok is not None else pred
            if spec.alive:
                if trunk:      # gates all traffic: alive = arrived & ok
                    carrier["alive"] = ok_of[node.name]
                else:          # branch tile: judge only its own packets
                    prev = carrier.get("alive")
                    if prev is None:
                        prev = torch.ones((n,), dtype=torch.bool,
                                          device=device)
                    carrier["alive"] = torch.where(pred, ok_of[node.name],
                                                   prev)
            if count_nodes:
                pkts_in.append(pred.sum(dtype=torch.int32))
                drops.append((pred & ~ok_of[node.name]).sum(
                    dtype=torch.int32))
            if count_drops:
                # drop attribution: hard drops (arrived & failed) plus
                # soft drops (tile set a reason but kept the packet alive);
                # hard drops with no tile-supplied code count as UNSPEC
                reason = carrier["drop_reason"]
                hard = pred & ~ok_of[node.name]
                counted = hard | (pred & (reason > 0))
                reason = torch.where(counted & (reason == 0),
                                     reasons.UNSPEC, reason)
                drop_blocks.append(telemetry.reason_counts(
                    reason, counted, reasons.NUM_REASONS))

        # ---- telemetry: ONE stacked row write for the whole batch --------
        if count_nodes:
            lat, node_idx = self._node_columns(device)
            rows = telemetry.counter_rows(
                telem["step"], torch.stack(pkts_in), torch.stack(drops),
                lat, node_idx)
            telem["nodes"] = telemetry.append_stacked(telem["nodes"], rows)
        if count_drops and drop_blocks:
            telem["drops"] = telem["drops"] + torch.stack(drop_blocks)
        return state, carrier

    # ---- streamed execution ------------------------------------------------
    def run_stream(self, state: Dict[str, Any], payloads: torch.Tensor,
                   lengths: torch.Tensor,
                   out_keys: Optional[Sequence[str]] = None):
        """Run N batches with the state carried from one to the next:
        ``payloads`` is a (N, B, L) frame arena with (N, B) ``lengths``,
        and the selected carrier outputs come back stacked along a leading
        axis.  A plain Python loop of :meth:`run` calls, so it equals N
        sequential calls by construction; it never synchronizes with the
        host, so the card runs ahead of the loop.

        Returns ``(state', outs)`` with ``outs[k]`` of shape (N, ...)."""
        keys = self.STREAM_OUT_KEYS if out_keys is None else tuple(out_keys)
        steps = []
        for i in range(payloads.shape[0]):
            state, carrier = self.run(
                state, {"payload": payloads[i], "length": lengths[i]})
            steps.append({k: carrier[k] for k in keys if k in carrier})
        return state, _stack_outs(steps)


def _stack_outs(steps: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Stack a list of per-batch output dicts (values: tensors or dicts
    of tensors) along a new leading axis."""
    if not steps:
        return {}
    out: Dict[str, Any] = {}
    for k, v in steps[0].items():
        if isinstance(v, dict):
            out[k] = {f: torch.stack([s[k][f] for s in steps])
                      for f in v}
        else:
            out[k] = torch.stack([s[k] for s in steps])
    return out


# ---------------------------------------------------------------------------
# the generic app-group tile function (dispatch + process, paper §4.2/§5)


def _app_init(ctx: TileContext) -> dict:
    from repro_torch.core.scaleout import make_dispatch
    a = ctx.binding
    if a is None:
        raise CompileError(f"app group {ctx.name!r} has no binding")
    # fresh tensors per init_state: the AppDecl holds its template state by
    # reference, and the executor's updates must never reach the template
    fresh = tree_map(lambda t: t.clone(), a.state)
    return {"dispatch": {a.name: make_dispatch(list(range(a.n_replicas)))},
            "apps": {a.name: fresh}}


@register_tile("app", init=_app_init)
def _app_group(state, carrier, pred, ctx):
    """Replica dispatch + app processing for one app group.  `pred` IS the
    arrival predicate derived from the udp_port route entries."""
    from repro_torch.core.scaleout import dispatch_lane
    a = ctx.binding
    m = carrier["meta"]
    at_app = pred

    dispatch = dict(state["dispatch"])
    apps = dict(state["apps"])
    d, replica = dispatch_lane(dispatch[a.name], a.policy, m, at_app,
                               base_port=a.port)
    dispatch[a.name] = d

    ast, nb, nl = a.process(apps[a.name], carrier["body"], carrier["blen"],
                            m, at_app, replica)
    apps[a.name] = ast
    state = dict(state)
    state["dispatch"] = dispatch
    state["apps"] = apps

    carrier["out_body"] = torch.where(at_app[:, None], nb,
                                      carrier["out_body"])
    carrier["out_blen"] = torch.where(at_app, nl, carrier["out_blen"])
    info = dict(carrier["info"])
    info[a.name] = at_app
    carrier["info"] = info
    return state, carrier, None
