"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version: ``checksum`` (RFC 1071), ``rs_encode`` (GF(256) RS parity),
``flash_attention`` (prefill attention) and ``mamba_scan`` (the Mamba-1
selective scan of prefill).  The CUDA sources are in ``repro_torch/csrc``;
``repro_torch._build`` compiles them at first use."""
