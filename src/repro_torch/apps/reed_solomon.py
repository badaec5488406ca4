"""Reed-Solomon erasure-coding application tile (paper §5.1, §6.5).

Stateless RS(8,2) encoder on 4 KiB requests: the client sends a 4 KiB data
block over UDP RPC; the reply carries the 1 KiB of parity (two 512 B
shards).  Replicated with round-robin dispatch — any request can go to any
copy.  Each replica logs served bytes (the paper's bandwidth metadata).
The parity comes from the RS kernel (``kernels/rs_encode``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.rs_encode import ops as rs_ops

K, P = 8, 2
REQ = 4096
RESP = REQ // K * P     # 1024


def make(name: str = "rs", port: int = 9000, n_replicas: int = 4):
    from repro_torch.net.stack import AppDecl

    def process(state, body, blen, meta, active, replica):
        parity = rs_ops.encode_blocks(body[:, :REQ], k=K, p=P)
        out = torch.zeros_like(body)
        out[:, :RESP] = parity
        lane = replica.to(torch.int64)
        served = state["bytes"].clone().index_add_(
            0, lane, torch.where(active, REQ, 0).to(torch.int32))
        ops = state["ops"].clone().index_add_(0, lane,
                                              active.to(torch.int32))
        return {"bytes": served, "ops": ops}, out, \
            torch.where(active, RESP, blen).to(torch.int32)

    state = {"bytes": torch.zeros((n_replicas,), dtype=torch.int32),
             "ops": torch.zeros((n_replicas,), dtype=torch.int32)}
    return AppDecl(name=name, port=port, n_replicas=n_replicas,
                   policy="round_robin", process=process, state=state)
