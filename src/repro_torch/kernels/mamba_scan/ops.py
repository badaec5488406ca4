"""The selective-scan wrapper: the hand-written CUDA kernel for tensors on
the card (``csrc/mamba_scan.cu``), its plain version (``ref.py``) for
tensors on the CPU.  There is no fallback: a CUDA tensor launches the
kernel or raises.

``mamba_scan.launches`` counts kernel launches (plain-version calls do not
count), so a run can show that prefill went through the kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.mamba_scan.ref import mamba_scan_ref

MAX_STATE = 32          # the kernel keeps a channel's state in one warp


def mamba_scan(u: torch.Tensor, dt: torch.Tensor, bm: torch.Tensor,
               cm: torch.Tensor, A: torch.Tensor):
    """The Mamba-1 selective scan: u, dt (B, S, D); bm, cm (B, S, N); A
    (D, N), all float32 -> (y (B, S, D), h_last (B, D, N)) float32, with
    ``h_t = exp(dt_t A) h_{t-1} + (dt_t u_t) B_t`` from ``h_0 = 0`` and
    ``y_t = sum_n h_t C_t``.  Any S >= 1 and D, N up to 32.  The inputs
    may be strided views (``bm`` and ``cm`` are column slices of the
    model's ``x_proj`` output): the kernel reads them by strides."""
    if u.dim() != 3 or dt.shape != u.shape or bm.dim() != 3 \
            or cm.shape != bm.shape or A.dim() != 2:
        raise ValueError(f"want u, dt (B, S, D), bm, cm (B, S, N) and A "
                         f"(D, N), got {tuple(u.shape)}, {tuple(dt.shape)}, "
                         f"{tuple(bm.shape)}, {tuple(cm.shape)}, "
                         f"{tuple(A.shape)}")
    B, S, D = u.shape
    N = A.shape[1]
    if bm.shape[:2] != (B, S) or bm.shape[2] != N or A.shape[0] != D:
        raise ValueError(f"shapes do not agree: u {tuple(u.shape)}, bm "
                         f"{tuple(bm.shape)}, A {tuple(A.shape)}")
    if S < 1:
        raise ValueError("an empty sequence has no scan")
    if any(t.dtype != torch.float32 for t in (u, dt, bm, cm, A)):
        raise ValueError(f"dtypes {[str(t.dtype) for t in (u, dt, bm, cm, A)]}"
                         f": want float32")
    if u.device.type == "cpu":
        return mamba_scan_ref(u, dt, bm, cm, A)
    if u.device.type != "cuda" or any(t.device != u.device
                                      for t in (dt, bm, cm, A)):
        raise ValueError(f"no mamba-scan kernel for devices "
                         f"{[str(t.device) for t in (u, dt, bm, cm, A)]}")
    if N > MAX_STATE:
        raise ValueError(f"state width N={N}: the kernel takes N up to "
                         f"{MAX_STATE}")
    if B > 65535:
        raise ValueError(f"batch {B}: the kernel takes up to 65535 rows")
    from repro_torch import _build
    y = torch.empty((B, S, D), dtype=torch.float32, device=u.device)
    h_last = torch.empty((B, D, N), dtype=torch.float32, device=u.device)
    err = _build.load().beehive_mamba_scan(
        u.data_ptr(), dt.data_ptr(), bm.data_ptr(), cm.data_ptr(),
        A.data_ptr(), y.data_ptr(), h_last.data_ptr(), B, S, D, N,
        *u.stride(), *dt.stride(), *bm.stride(), *cm.stride(), *A.stride(),
        torch.cuda.current_stream(u.device).cuda_stream)
    _build.check(err, "mamba_scan")
    mamba_scan.launches += 1
    return y, h_last


mamba_scan.launches = 0
