"""The flash-attention wrapper: the hand-written CUDA kernel for tensors on
the card (``csrc/flash_attention.cu``), its plain version (``ref.py``) for
tensors on the CPU.  There is no fallback: a CUDA tensor launches the
kernel or raises.

``flash_attention.launches`` counts kernel launches (plain-version calls
do not count), so a run can show that prefill went through the kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.ref import attention_model_ref

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """Forward attention in the model layout: q (B, S, KV, G, hd), k and v
    (B, S, KV, hd) -> (B, S, KV, G, hd) in q's dtype, with a causal and an
    optional sliding-window mask (``window`` = 0: none).  Any S; hd a
    multiple of 16 up to 256; float32 or bfloat16.  The tensors may be
    strided views as long as their last axis is contiguous (in bfloat16
    their rows must also start on 16-byte boundaries, or it raises).  On
    the card bfloat16 runs on the tensor cores with the weights P rounded
    to bfloat16 before the value product, as the model's own attention
    rounds them; float32 runs in full float32."""
    if q.dim() != 5 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"want q (B, S, KV, G, hd) and k, v (B, S, KV, hd),"
                         f" got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, S, KV, G, hd = q.shape
    if k.shape != (B, S, KV, hd):
        raise ValueError(f"k, v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"dtypes {q.dtype}, {k.dtype}, {v.dtype}: want "
                         f"float32 or bfloat16, all the same")
    if hd % 16 or not 16 <= hd <= 256:
        raise ValueError(f"head dim {hd}: want a multiple of 16 up to 256")
    if window < 0:
        raise ValueError(f"window {window} < 0")
    if q.device.type == "cpu":
        return attention_model_ref(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda" or k.device != q.device \
            or v.device != q.device:
        raise ValueError(f"no flash-attention kernel for devices "
                         f"{q.device}, {k.device}, {v.device}")
    from repro_torch import _build
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    if q.dtype == torch.bfloat16:
        for name, t in (("q", q), ("k", k), ("v", v)):
            _check_rows_aligned(name, t)
    out = torch.empty((B, S, KV, G, hd), dtype=q.dtype, device=q.device)
    err = _build.load().beehive_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, S, KV * G, KV, hd, *q.stride()[:4], *k.stride()[:3],
        *v.stride()[:3], *out.stride()[:4], int(bool(causal)), int(window),
        _DTYPE_CODE[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def _check_rows_aligned(name: str, t: torch.Tensor) -> None:
    """The bf16 kernel copies rows with 16-byte ``cp.async``: the base
    pointer and the stride of every axis longer than 1 must be multiples
    of 16 bytes (8 elements)."""
    if t.data_ptr() % 16 or any(n > 1 and s % 8 for n, s in
                                zip(t.shape[:-1], t.stride()[:-1])):
        raise ValueError(f"flash_attention: bf16 {name} rows are not "
                         f"16-byte aligned (data_ptr % 16 = "
                         f"{t.data_ptr() % 16}, strides {t.stride()}): the "
                         f"kernel copies rows in 16-byte pieces")
