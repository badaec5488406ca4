"""Network-on-chip model: 2-D mesh geometry, dimension-ordered (X-then-Y)
wormhole routing, and the message/flit cost model.

This is the structural substrate of Beehive (paper §3.1, §4.1): tiles sit at
(x, y) coordinates; messages traverse router-to-router channels computed by
deterministic DOR.  The JAX runtime moves *batches* in one shot, but every
chain declared by a topology is validated against this model (deadlock
analysis, latency/bandwidth projections), exactly like the paper's
compile-time tooling.

Cost-model constants follow the paper's prototype: 512-bit flits at 250 MHz
(OpenPiton-derived mesh on the Alveo U200), one header flit per message,
per-hop router latency of 2 cycles.  The paper measures 368 ns (92 cycles)
through the full UDP RX+TX chain.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, List, Sequence, Tuple

Coord = Tuple[int, int]

FLIT_BITS = 512
CLOCK_HZ = 250e6
ROUTER_HOP_CYCLES = 2
TILE_PROC_CYCLES = 10          # parse/strip/construct per protocol tile
MAX_NOC_PAYLOAD = 256 * 2**20  # 256 MiB (paper §4.1)


@dataclasses.dataclass(frozen=True)
class Channel:
    """A directed router-to-router link (or injection/ejection port)."""
    src: Coord
    dst: Coord

    def __repr__(self):
        return f"{self.src}->{self.dst}"


def dor_path(src: Coord, dst: Coord) -> List[Channel]:
    """Dimension-ordered (X then Y) route between two routers."""
    path: List[Channel] = []
    x, y = src
    while x != dst[0]:
        nx = x + (1 if dst[0] > x else -1)
        path.append(Channel((x, y), (nx, y)))
        x = nx
    while y != dst[1]:
        ny = y + (1 if dst[1] > y else -1)
        path.append(Channel((x, y), (x, ny)))
        y = ny
    return path


def chain_channels(coords: Sequence[Coord]) -> List[Channel]:
    """All channels acquired, in order, by a message chain across tiles.

    Wormhole streaming means a chain holds its channels in acquisition
    order; a chain that must re-acquire an earlier channel deadlocks
    against itself or a peer (paper Fig. 5)."""
    out: List[Channel] = []
    for a, b in zip(coords, coords[1:]):
        out.extend(dor_path(a, b))
    return out


def flits_for(payload_bytes: int) -> int:
    body = -(-payload_bytes * 8 // FLIT_BITS)
    return 1 + body  # header flit + body flits


def chain_latency_cycles(coords: Sequence[Coord], payload_bytes: int) -> int:
    """Cut-through latency of a message chain (cycles): per-hop router
    latency + per-tile processing + serialization of the message tail."""
    hops = len(chain_channels(coords))
    tiles = len(coords)
    return (hops * ROUTER_HOP_CYCLES + tiles * TILE_PROC_CYCLES
            + flits_for(payload_bytes))


def chain_latency_ns(coords: Sequence[Coord], payload_bytes: int) -> float:
    return chain_latency_cycles(coords, payload_bytes) / CLOCK_HZ * 1e9


def link_bandwidth_gbps() -> float:
    return FLIT_BITS * CLOCK_HZ / 1e9  # 128 Gbps per mesh link


def mesh_coords(dim_x: int, dim_y: int) -> Iterator[Coord]:
    for y in range(dim_y):
        for x in range(dim_x):
            yield (x, y)
