"""PyTorch + CUDA port of the Beehive reproduction (``repro``).

The Figure-4 UDP/RPC path — eth -> ip -> udp (+ RPC deframe) -> app ->
udp -> ip -> eth — compiled from a topology and run per batch or streamed,
with the direct-attached RS(8,2) and LM serving tiles.  The LM path runs
the model (``models``: the attention architectures of ``configs``), the
``ServeEngine`` and the ``lm_serve`` tile, whose session KV cache lives in
the stack's state.  Three hand-written CUDA kernels carry it: the RFC 1071
checksum, the GF(256) Reed-Solomon encoder and flash attention (prefill).
This package imports neither JAX nor ``repro``; importing it builds
nothing and needs no GPU.
"""
