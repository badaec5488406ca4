"""Stack assembly: declarative topologies (the paper's XML analog) compiled
into executable pipelines.

`udp_topology()` is Figure 4 as *configuration*: eth -> ip -> udp -> app(s)
and back, every hop a route entry.  `rpc_serve_topology()` dispatches app
tiles on the RPC frame's msg_type.  `UdpStack` builds (or accepts) a
topology, hands it to :class:`repro_torch.core.compiler.StackCompiler`, and
exposes the compiled pipeline as ``rx_tx`` / ``run_stream``.

Entry points run on the card: ``UdpStack(..., device=None)`` means
``cuda``, and raises when CUDA is absent unless ``device="cpu"`` is asked
for.  On the CPU every kernel runs as its plain PyTorch version.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

import torch

from repro_torch.core.compiler import (CompileError, StackCompiler,
                                      resolve_device)
from repro_torch.core.topology import TopologyConfig
from repro_torch.net import ipv4
from repro_torch.net import tiles as _tiles    # noqa: F401  (registers kinds)


@dataclasses.dataclass
class AppDecl:
    name: str
    port: int                  # UDP port (port-match apps: base port)
    n_replicas: int = 1
    policy: str = "round_robin"   # round_robin | flow_hash | port_match
    # process(state, body, blen, meta, active, replica) -> (state, body', blen')
    process: Optional[Callable] = None
    state: object = None


def _place_apps(topo: TopologyConfig, apps: List[AppDecl], row: int):
    x = 3
    for app in apps:
        for r in range(app.n_replicas):
            nm = f"{app.name}.{r}" if app.n_replicas > 1 else app.name
            topo.add_tile(nm, f"app:{app.name}", x, row)
            topo.add_chain("eth_rx", "ip_rx", "udp_rx", nm,
                           "udp_tx", "ip_tx", "eth_tx")
            # reply path: app -> udp_tx -> ip_tx -> eth_tx
            topo.add_route(nm, "const", None, "udp_tx")
            x += 1


def _rx_tx_tiles(topo: TopologyConfig) -> None:
    topo.add_tile("eth_rx", "eth_rx", 0, 0)
    topo.add_tile("ip_rx", "ip_rx", 1, 0)
    topo.add_tile("udp_rx", "udp_rx", 2, 0)
    topo.add_tile("eth_tx", "eth_tx", 0, 1)
    topo.add_tile("ip_tx", "ip_tx", 1, 1)
    topo.add_tile("udp_tx", "udp_tx", 2, 1)
    topo.add_route("eth_rx", "ethertype", 0x0800, "ip_rx")
    topo.add_route("ip_rx", "ip_proto", ipv4.PROTO_UDP, "udp_rx")
    topo.add_route("udp_tx", "const", None, "ip_tx")
    topo.add_route("ip_tx", "const", None, "eth_tx")


def udp_topology(apps: List[AppDecl], name="udp-stack") -> TopologyConfig:
    width = 3 + sum(a.n_replicas for a in apps)
    topo = TopologyConfig(name, max(width, 4), 2)
    _rx_tx_tiles(topo)
    _place_apps(topo, apps, 0)
    for app in apps:
        if app.policy == "port_match":
            # one CAM entry per shard port (paper: 'distribute work to the
            # tiles by matching on the destination port number')
            for r in range(app.n_replicas):
                nm = f"{app.name}.{r}" if app.n_replicas > 1 else app.name
                topo.add_route("udp_rx", "udp_port", app.port + r, nm)
        else:
            nm = f"{app.name}.0" if app.n_replicas > 1 else app.name
            topo.add_route("udp_rx", "udp_port", app.port, nm)
    return topo


def rpc_serve_topology(tiles: List[Tuple[str, str, int]],
                       name: str = "rpc-serve-stack",
                       params: Optional[dict] = None) -> TopologyConfig:
    """Direct-attached serving topology: eth -> ip -> udp, then the app
    tiles dispatched on the RPC frame's ``msg_type`` (the ``rpc_msg``
    match space), on any UDP port.  ``tiles`` is a list of (tile_name,
    tile_kind, msg_type) triples, e.g. ``[("rs", "rs_serve",
    rpc.MSG_RS_ENCODE)]``.  The msg_type CAM (``udp_rx:rpc_msg``) is a
    runtime table.  ``params`` maps tile_name -> TileDecl params."""
    params = params or {}
    topo = TopologyConfig(name, max(4, 3 + len(tiles)), 2)
    _rx_tx_tiles(topo)
    for i, (nm, kind, msg) in enumerate(tiles):
        topo.add_tile(nm, kind, 3 + i, 0, params=params.get(nm))
        topo.add_chain("eth_rx", "ip_rx", "udp_rx", nm,
                       "udp_tx", "ip_tx", "eth_tx")
        topo.add_route("udp_rx", "rpc_msg", msg, nm)
        topo.add_route(nm, "const", None, "udp_tx")
    return topo


class UdpStack:
    """Figure-4 pipeline, compiled from its topology.

    ``mgmt_port`` (the in-band management plane) is not ported yet
    (ROADMAP queue 1 item 7) and raises :class:`CompileError`; so does
    ``with_obs=True`` at :meth:`init_state` (item 9)."""

    def __init__(self, apps: List[AppDecl], local_ip: int,
                 check_deadlock: bool = True,
                 topo: Optional[TopologyConfig] = None,
                 with_telemetry: bool = True,
                 mgmt_port: Optional[int] = None,
                 options: Optional[dict] = None,
                 with_obs: bool = False,
                 device=None):
        if mgmt_port is not None:
            raise CompileError("mgmt_port: the management plane is not "
                               "ported yet (ROADMAP queue 1 item 7)")
        self.device = resolve_device(device)
        self.topo = topo if topo is not None else udp_topology(apps)
        self.apps = apps
        self.local_ip = local_ip
        self.with_telemetry = with_telemetry
        self.with_obs = with_obs
        opts = {"local_ip": local_ip}
        opts.update(options or {})
        self.compiler = StackCompiler(
            self.topo, bindings={a.name: a for a in apps},
            options=opts, check_deadlock=check_deadlock)
        self.pipeline = self.compiler.compile("eth_rx")

    def init_state(self):
        st = self.pipeline.init_state(with_telemetry=self.with_telemetry,
                                      with_obs=self.with_obs,
                                      device=self.device)
        st["rx_count"] = torch.zeros((), dtype=torch.int32,
                                     device=self.device)
        return st

    def rx_tx(self, state, payload, length):
        """Full compiled chain: parse -> dispatch -> app -> build.  Returns
        (state', out_payload, out_length, out_valid, info)."""
        state, carrier = self.pipeline.run(
            state, {"payload": payload, "length": length})
        state["rx_count"] = state["rx_count"] + \
            carrier["alive"].sum(dtype=torch.int32)
        return (state, carrier["tx_payload"], carrier["tx_len"],
                carrier["alive"], carrier["info"])

    def run_stream(self, state, payloads, lengths):
        """Streamed rx_tx: N batches (a (N, B, L) frame arena + (N, B)
        lengths) with the state carried and no host synchronization
        between batches.  Returns (state', outs) with outs holding stacked
        ``tx_payload`` / ``tx_len`` / ``alive`` / ``info``.  Equal to N
        sequential :meth:`rx_tx` calls."""
        state, outs = self.pipeline.run_stream(state, payloads, lengths)
        state = dict(state)
        state["rx_count"] = state["rx_count"] + \
            outs["alive"].sum(dtype=torch.int32)
        return state, outs

    def stream_fn(self):
        """The streaming entry point: ``state, outs = stack.stream_fn()(
        state, payloads, lengths)``.  The reference jits and donates the
        state here; PyTorch runs eagerly, so this is :meth:`run_stream`."""
        return self.run_stream
