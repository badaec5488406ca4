"""Replica dispatch policies (paper §3.2, §4.2, §5), vectorized over the
packet batch:

  round_robin  — stateless services (Reed-Solomon encoder, echo)
  flow_hash    — per-flow state: FNV-1a(4-tuple) mod N pins a flow
  port_match   — shard-keyed services: dst port -> replica

The dispatch table is runtime state, so the control plane can re-balance
(or route around a dead replica) without rebuilding anything.  Lowering a
topology's ``replica_groups`` is not ported yet (ROADMAP queue 1, item 8).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.core.routing import flow_hash

I32 = torch.int32


@dataclasses.dataclass
class DispatchState:
    replica_ids: torch.Tensor    # (N,) int32 tile ids
    healthy: torch.Tensor        # (N,) bool — control plane can mark down
    rr_counter: torch.Tensor     # () int32
    served: torch.Tensor         # (N,) int32 packets dispatched per replica


def make_dispatch(replica_tile_ids: Sequence[int],
                  device=None) -> DispatchState:
    n = len(replica_tile_ids)
    return DispatchState(
        replica_ids=torch.tensor(list(replica_tile_ids), dtype=I32,
                                 device=device),
        healthy=torch.ones((n,), dtype=torch.bool, device=device),
        rr_counter=torch.zeros((), dtype=I32, device=device),
        served=torch.zeros((n,), dtype=I32, device=device),
    )


def _healthy_pick(d: DispatchState, idx: torch.Tensor) -> torch.Tensor:
    """Remap an index onto healthy replicas only (failure routing)."""
    healthy_idx = torch.cumsum(d.healthy.to(I32), dim=0) - 1  # rank of each
    n_healthy = torch.clamp(d.healthy.sum(dtype=I32), min=1)
    target_rank = torch.remainder(idx.to(I32), n_healthy)
    # first replica whose rank == target_rank and healthy
    match = (healthy_idx[None, :] == target_rank[:, None]) \
        & d.healthy[None, :]
    pick = torch.argmax(match.to(I32), dim=1)
    return d.replica_ids[pick]


def round_robin(d: DispatchState, mask: torch.Tensor
                ) -> Tuple[DispatchState, torch.Tensor]:
    """Stateless spraying: packet i -> (counter + rank_of_i_in_mask) mod N."""
    order = torch.cumsum(mask.to(I32), dim=0) - 1
    idx = d.rr_counter + torch.where(mask, order, 0)
    nxt = _healthy_pick(d, idx)
    d = dataclasses.replace(d, rr_counter=d.rr_counter
                            + mask.sum(dtype=I32))
    return d, nxt


def by_flow_hash(d: DispatchState, meta) -> torch.Tensor:
    """Flow-affine: same 4-tuple always lands on the same replica."""
    return _healthy_pick(d, flow_hash(meta) & 0x7FFFFFFF)


def by_port(d: DispatchState, port: torch.Tensor,
            base_port: int) -> torch.Tensor:
    """Shard-keyed: dst_port - base_port indexes the replica."""
    return _healthy_pick(d, port.to(torch.int64) - base_port)


def mark_health(d: DispatchState, replica: int, up: bool) -> DispatchState:
    """Control-plane operation: drain or restore one replica."""
    healthy = d.healthy.clone()
    healthy[replica] = up
    return dataclasses.replace(d, healthy=healthy)


def dispatch_lane(d: DispatchState, policy: str, meta, pred: torch.Tensor,
                  base_port: Optional[int] = None
                  ) -> Tuple[DispatchState, torch.Tensor]:
    """One dispatch decision per batch row under `policy`: returns
    (d', lane).  Advances rr_counter (round_robin) and bumps the
    per-replica served counters for rows where `pred` holds (an
    ``index_add_``: duplicate lanes accumulate, as the reference's
    ``.at[lane].add`` does)."""
    if policy == "round_robin":
        d, lane = round_robin(d, pred)
    elif policy == "flow_hash":
        lane = by_flow_hash(d, meta)
    elif policy == "port_match":
        lane = by_port(d, meta["dst_port"], base_port)
    else:
        raise ValueError(f"unknown dispatch policy {policy!r}")
    served = d.served.clone().index_add_(0, lane.to(torch.int64),
                                         pred.to(I32))
    return dataclasses.replace(d, served=served), lane
