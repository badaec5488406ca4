"""Telemetry (paper §4.6): fixed-size ring logs in the stack state.

Every compiled pipeline keeps one stacked counter log — one
``(num_nodes, LOG_WIDTH)`` row block per batch, written with a single
indexed copy at batch egress — and one ``(num_nodes, NUM_REASONS)``
drop-reason table.  Row layout: ``[step, packets_in, drops,
noc_latency_cycles, tile_index, 0, 0, 0]``.
"""
from __future__ import annotations

import dataclasses

import torch

LOG_WIDTH = 8          # int32 words per entry
PIPE_LOG_ENTRIES = 64  # ring depth of every compiled-pipeline log

I32 = torch.int32


@dataclasses.dataclass
class RingLog:
    entries: torch.Tensor     # (N, LOG_WIDTH) or (N, num_nodes, LOG_WIDTH)
    wr: torch.Tensor          # () int32 — total writes (head = wr % N)
    req_fill: torch.Tensor    # () or (num_nodes,) int32 — pending readbacks


def make_node_log(num_nodes: int, n_entries: int = PIPE_LOG_ENTRIES,
                  device=None) -> RingLog:
    return RingLog(
        entries=torch.zeros((n_entries, num_nodes, LOG_WIDTH), dtype=I32,
                            device=device),
        wr=torch.zeros((), dtype=I32, device=device),
        req_fill=torch.zeros((num_nodes,), dtype=I32, device=device),
    )


def append_stacked(log: RingLog, rows: torch.Tensor) -> RingLog:
    """Append one (num_nodes, LOG_WIDTH) row block.  The slot is a device
    tensor, so the write is an ``index_copy`` with a one-element index —
    indexing with a 0-d tensor could read it back to the host."""
    n = log.entries.shape[0]
    slot = torch.remainder(log.wr, n).reshape(1).to(torch.int64)
    entries = log.entries.index_copy(0, slot, rows[None].to(I32))
    return dataclasses.replace(log, entries=entries, wr=log.wr + 1)


def timestamp(step_counter: torch.Tensor) -> torch.Tensor:
    """Cycle-timestamp analog: the runtime's step counter."""
    return step_counter.to(I32)


def counter_rows(step, pkts_in, drops, lat_cycles,
                 tile_index) -> torch.Tensor:
    """The whole pipeline's counter block: (num_nodes, LOG_WIDTH) from
    per-node (num_nodes,) columns."""
    n = pkts_in.shape[0]
    zero = torch.zeros((n,), dtype=I32, device=pkts_in.device)
    return torch.stack([
        timestamp(step).expand(n),
        pkts_in.to(I32),
        drops.to(I32),
        lat_cycles.to(I32),
        tile_index.to(I32),
        zero, zero, zero,
    ], dim=1)


def make_drop_table(num_nodes: int, num_reasons: int,
                    device=None) -> torch.Tensor:
    return torch.zeros((num_nodes, num_reasons), dtype=I32, device=device)


def reason_counts(reason: torch.Tensor, counted: torch.Tensor,
                  num_reasons: int) -> torch.Tensor:
    """One node's (num_reasons,) counts for one batch: `reason` (B,)
    int32 codes, `counted` (B,) bool (which rows to attribute)."""
    codes = torch.arange(num_reasons, device=reason.device)
    hot = (reason[:, None] == codes[None, :]) & counted[:, None]
    return hot.sum(dim=0, dtype=I32)


def node_view(log: RingLog, index: int) -> RingLog:
    """One node's slice of the stacked log as an ordinary RingLog, so
    `latest` works unchanged."""
    return RingLog(entries=log.entries[:, index, :], wr=log.wr,
                   req_fill=log.req_fill[index])


def latest(log: RingLog, n: int = 1) -> torch.Tensor:
    """The last n entries, oldest first (readback convenience)."""
    cap = log.entries.shape[0]
    back = torch.arange(n, 0, -1, device=log.wr.device)
    return log.entries[torch.remainder(log.wr - back, cap).to(torch.int64)]
