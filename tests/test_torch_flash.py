"""The port's flash-attention kernel module against the reference: the plain
version against ``attention_ref`` and against ``flash_attention_pallas``
(interpret mode), the model-layout wrapper against the model's own
``_attn_dense`` / ``_attn_online``, and — on a machine with a GPU — the
CUDA kernel against the plain version.

Tolerances are the reference's kernel tests' (``tests/test_kernels.py``):
2e-5 in float32 (sums taken in another order), 2e-2 in bfloat16 (inputs
rounded to 8 bits of mantissa).  The CUDA tests decide inside a fixture
whether there is a card and skip with the reason when there is none (the
kernel is CUDA C++: it has no interpret mode).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import flash_attention_pallas
from repro.kernels.flash_attention.ref import attention_ref as j_attention_ref
from repro.models import layers as JL
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import (attention_model_ref,
                                                     attention_ref)
from repro_torch.models import layers as TL

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
J_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
T_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel is CUDA C++ with no "
                    "interpret mode (python3 chip_smoke.py runs it)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def qkv(seed, shapes, dtype):
    """Seeded numpy inputs (scaled normal), rounded to ``dtype`` once so
    both packages see the same values."""
    rng = np.random.default_rng(seed)
    out = []
    for shape in shapes:
        a = (rng.standard_normal(shape) * 0.5).astype(np.float32)
        t = torch.from_numpy(a).to(T_DT[dtype])
        out.append((jnp.asarray(t.float().numpy()).astype(J_DT[dtype]), t))
    return out


def close(got: torch.Tensor, want, dtype):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


# ---------------------------------------------------------------------------
# the plain version against the reference's oracle and Pallas kernel


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [0, 64])
@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("hd", [16, 64])
@pytest.mark.parametrize("S", [128, 256])
def test_plain_vs_attention_ref(S, hd, G, window, causal, dtype):
    KV = 2
    (jq, tq), (jk, tk), (jv, tv) = qkv(
        S * hd + G + window, [(KV * G, S, hd), (KV, S, hd), (KV, S, hd)],
        dtype)
    want = j_attention_ref(jq, jk, jv, causal=causal, window=window)
    close(attention_ref(tq, tk, tv, causal=causal, window=window), want,
          dtype)


@pytest.mark.parametrize("S", [1, 129, 200])
def test_plain_vs_attention_ref_odd_lengths(S):
    (jq, tq), (jk, tk), (jv, tv) = qkv(S, [(4, S, 32), (2, S, 32),
                                           (2, S, 32)], "float32")
    for causal, window in ((True, 0), (True, 64), (False, 0)):
        want = j_attention_ref(jq, jk, jv, causal=causal, window=window)
        close(attention_ref(tq, tk, tv, causal=causal, window=window), want,
              "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [0, 64])
def test_plain_vs_pallas_interpret(window, dtype):
    S, hd = 256, 64
    (jq, tq), (jk, tk), (jv, tv) = qkv(7 + window, [(4, S, hd), (2, S, hd),
                                                    (2, S, hd)], dtype)
    want = flash_attention_pallas(jq, jk, jv, causal=True, window=window,
                                  bq=128, bk=128, interpret=True)
    close(attention_ref(tq, tk, tv, causal=True, window=window), want, dtype)


def test_plain_vs_pallas_interpret_bidirectional():
    (jq, tq), (jk, tk), (jv, tv) = qkv(3, [(2, 256, 64)] * 3, "float32")
    want = flash_attention_pallas(jq, jk, jv, causal=False, bq=128, bk=128,
                                  interpret=True)
    close(attention_ref(tq, tk, tv, causal=False), want, "float32")


# ---------------------------------------------------------------------------
# the model-layout wrapper against the model's attention paths


@pytest.mark.parametrize("window", [0, 64])
@pytest.mark.parametrize("S", [256, 200])
def test_ops_model_layout_vs_model_attention(S, window):
    B, KV, G, hd = 2, 2, 2, 64
    (jq, tq), (jk, tk), (jv, tv) = qkv(S + window, [
        (B, S, KV, G, hd), (B, S, KV, hd), (B, S, KV, hd)], "float32")
    got = flash_ops.flash_attention(tq, tk, tv, causal=True, window=window)
    assert got.shape == (B, S, KV, G, hd) and got.dtype == torch.float32
    pos = jnp.arange(S)
    close(got, JL._attn_dense(jq, jk, jv, pos, pos, window), "float32")
    close(got, JL._attn_online(jq, jk, jv, pos, pos, window, blk=128),
          "float32")
    # the port's own online-softmax version (its plain path above 2048)
    tpos = torch.arange(S)
    close(TL._attn_online(tq, tk, tv, tpos, tpos, window, blk=128),
          JL._attn_online(jq, jk, jv, pos, pos, window, blk=128), "float32")


@pytest.mark.parametrize("window", [0, 100])
@pytest.mark.parametrize("S", [129, 333])
@pytest.mark.parametrize("H,KV,hd", [(16, 16, 64), (16, 8, 256)])
def test_plain_vs_model_attention_with_bf16_weights(H, KV, hd, S, window):
    """The card's bf16 kernel rounds P to bf16 before the value product,
    as the model's own attention does (``w.astype(v.dtype)``).  At qwen's
    widths (H=16, hd=64) and gemma3-12b's (hd=256), causal and windowed,
    that attention stays within the bf16 tolerance of the plain version
    (float32 weights), the bound the card's check holds the kernel to."""
    (jq, tq), (jk, tk), (jv, tv) = qkv(
        S + hd + window, [(1, S, KV, H // KV, hd), (1, S, KV, hd),
                          (1, S, KV, hd)], "bfloat16")
    pos = jnp.arange(S)
    want = JL._attn_dense(jq, jk, jv, pos, pos, window)
    assert want.dtype == jnp.bfloat16
    close(attention_model_ref(tq, tk, tv, causal=True, window=window),
          np.asarray(want.astype(jnp.float32)), "bfloat16")


def test_ops_wrapper_cpu_counts_no_launch_and_validates():
    before = flash_ops.flash_attention.launches
    q = torch.zeros((1, 8, 1, 2, 16))
    k = torch.zeros((1, 8, 1, 16))
    flash_ops.flash_attention(q, k, k)
    assert flash_ops.flash_attention.launches == before
    with pytest.raises(ValueError, match="head dim"):
        flash_ops.flash_attention(torch.zeros((1, 8, 1, 2, 24)),
                                  torch.zeros((1, 8, 1, 24)),
                                  torch.zeros((1, 8, 1, 24)))
    with pytest.raises(ValueError, match="dtypes"):
        flash_ops.flash_attention(q, k.to(torch.bfloat16), k)
    with pytest.raises(ValueError, match="do not match"):
        flash_ops.flash_attention(q, torch.zeros((1, 9, 1, 16)),
                                  torch.zeros((1, 9, 1, 16)))
    with pytest.raises(ValueError, match="no flash-attention kernel"):
        flash_ops.flash_attention(q.to("meta"), k.to("meta"), k.to("meta"))


# ---------------------------------------------------------------------------
# on the card: the CUDA kernel against the plain version


CARD_CASES = [  # (S, H, KV, hd, window, causal)
    (1, 16, 16, 64, 0, True), (129, 16, 16, 64, 0, True),
    (1000, 16, 16, 64, 0, True), (256, 4, 2, 64, 0, True),
    (512, 8, 2, 128, 0, True), (256, 4, 2, 64, 128, True),
    (512, 8, 4, 64, 64, True), (300, 4, 4, 64, 0, False),
    (200, 4, 2, 16, 0, True), (130, 2, 1, 256, 32, True),
    # the bf16 kernel's edges: ragged tails around its 64-row tiles, a
    # window edge inside a key tile, G = 2, 4, 8, hubert-xlarge's hd 80
    # bidirectional, hd 128, gemma3-12b's hd 256 with a window
    (63, 16, 16, 64, 0, True), (64, 16, 16, 64, 0, True),
    (65, 16, 16, 64, 0, True), (127, 16, 16, 64, 0, True),
    (333, 16, 16, 64, 0, True), (333, 8, 4, 64, 100, True),
    (333, 16, 4, 64, 0, True), (333, 16, 2, 64, 0, True),
    (333, 16, 16, 80, 0, False), (333, 8, 2, 128, 0, True),
    (700, 16, 8, 256, 512, True)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,H,KV,hd,window,causal", CARD_CASES)
def test_kernel_vs_plain_on_card(cuda, S, H, KV, hd, window, causal, dtype):
    B, G = 2, H // KV
    (_, tq), (_, tk), (_, tv) = qkv(
        S + hd, [(B, S, KV, G, hd), (B, S, KV, hd), (B, S, KV, hd)], dtype)
    q, k, v = tq.to(cuda), tk.to(cuda), tv.to(cuda)
    before = flash_ops.flash_attention.launches
    got = flash_ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_ops.flash_attention.launches == before + 1
    want = attention_model_ref(q, k, v, causal=causal, window=window)
    close(got.cpu(), want.float().cpu().numpy(), dtype)


@pytest.mark.gpu
def test_kernel_strided_model_layout_on_card(cuda):
    B, S, KV, G, hd = 1, 333, 4, 2, 64
    rng = np.random.default_rng(0)
    wide = torch.from_numpy(rng.standard_normal(
        (B, S, KV, G, 2 * hd)).astype(np.float32)).to(cuda)
    kv = torch.from_numpy(rng.standard_normal(
        (B, S, 2, KV, hd)).astype(np.float32)).to(cuda)
    q, k, v = wide[..., hd:], kv[:, :, 0], kv[:, :, 1]
    got = flash_ops.flash_attention(q, k, v, causal=True, window=100)
    want = attention_model_ref(q, k, v, causal=True, window=100)
    close(got.cpu(), want.cpu().numpy(), "float32")


def test_bf16_row_alignment_is_checked():
    """The bf16 kernel copies rows in 16-byte pieces: the wrapper names a
    view whose rows it cannot take (a CPU tensor shows the check; on the
    card the check runs before every bf16 launch)."""
    wide = torch.zeros((1, 8, 2, 2, 80), dtype=torch.bfloat16)
    flash_ops._check_rows_aligned("q", wide[..., :64])      # 160-byte rows
    flash_ops._check_rows_aligned("q", wide[..., 16:])      # 32-byte offset
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_ops._check_rows_aligned("q", wide[..., 4:68])  # 8-byte offset
    odd = torch.zeros((1, 8, 2, 2, 68), dtype=torch.bfloat16)[..., :64]
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_ops._check_rows_aligned("k", odd)              # 136-byte rows
    flash_ops._check_rows_aligned("v", odd[:, :1, :1, :1])  # one row


@pytest.mark.gpu
def test_kernel_strided_bf16_view_on_card(cuda):
    """bf16 q, k, v as 16-byte aligned column views of wider tensors (the
    kernel's cp.async path with strides that are not the row width)."""
    B, S, KV, G, hd = 1, 333, 4, 2, 64
    rng = np.random.default_rng(1)
    wide = torch.from_numpy(rng.standard_normal(
        (B, S, KV, G, 2 * hd)).astype(np.float32)).to(cuda).bfloat16()
    kv = torch.from_numpy(rng.standard_normal(
        (B, S, 2, KV, hd)).astype(np.float32)).to(cuda).bfloat16()
    q, k, v = wide[..., hd:], kv[:, :, 0], kv[:, :, 1]
    got = flash_ops.flash_attention(q, k, v, causal=True, window=100)
    want = attention_model_ref(q, k, v, causal=True, window=100)
    close(got.float().cpu(), want.float().cpu().numpy(), "bfloat16")
