"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version: ``checksum`` (RFC 1071), ``rs_encode`` (GF(256) RS parity) and
``flash_attention`` (prefill attention).  The CUDA sources are in
``repro_torch/csrc``; ``repro_torch._build`` compiles them at first use."""
