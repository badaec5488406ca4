"""PyTorch + CUDA port of the Beehive reproduction (``repro``).

The Figure-4 UDP/RPC path — eth -> ip -> udp (+ RPC deframe) -> app ->
udp -> ip -> eth — compiled from a topology and run per batch or streamed,
with the direct-attached RS(8,2) serving tile.  Two hand-written CUDA
kernels carry it: the RFC 1071 checksum and the GF(256) Reed-Solomon
encoder.  This package imports neither JAX nor ``repro``; importing it
builds nothing and needs no GPU.
"""
