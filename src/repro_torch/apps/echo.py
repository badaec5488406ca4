"""UDP echo application tile (paper §6.3)."""
from __future__ import annotations

import torch


def make(name: str = "echo", port: int = 7, n_replicas: int = 1):
    from repro_torch.net.stack import AppDecl

    def process(state, body, blen, meta, active, replica):
        # echo: body unchanged; count per-replica service (index_add_:
        # duplicate replica ids accumulate)
        counts = state["served"].clone().index_add_(
            0, replica.to(torch.int64), active.to(torch.int32))
        return {"served": counts}, body, blen

    state = {"served": torch.zeros((n_replicas,), dtype=torch.int32)}
    return AppDecl(name=name, port=port, n_replicas=n_replicas,
                   policy="round_robin", process=process, state=state)
