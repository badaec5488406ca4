"""The direct-attached serving cell: which model backs the LM tile in the
serving benchmarks/tests, and the session-capacity knobs shared by the
host-mediated baseline and the compiled-stack path.

A *global-attention* architecture is required here: the direct tile (like
`ServeEngine.step`) runs one decode step over every session slot and masks
the position/token updates for sessions that did not advance — sound for
position-indexed KV caches (the spurious write lands at the stale `pos`
and is overwritten by the session's next real step), but not for
recurrent/rolling states, which mutate unconditionally.
"""
from __future__ import annotations

from repro_torch.configs import get_smoke_config

SERVE_ARCH = "qwen1.5-0.5b"     # smallest attention arch in the registry
MAX_SESSIONS = 4
MAX_SEQ = 64
LM_TILE = "lm"
RS_TILE = "rs"


def serve_config(**over):
    """The reduced-size serving model used by bench_rpc_tail and the
    serving tests (same family as the full arch, CPU-smoke shapes)."""
    return get_smoke_config(SERVE_ARCH, **over)
