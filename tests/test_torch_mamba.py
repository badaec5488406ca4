"""The port's Mamba-1 path against the reference: the selective-scan kernel
module (plain version against the reference's oracle ``mamba_scan_ref``,
its Pallas kernel in interpret mode and ``linear_recurrence``), and the
falcon-mamba model and ``ServeEngine`` at smoke size with the JAX
package's own parameters carried across by ``convert.params_from_numpy``.

Tolerances: the scan within 1e-4 (atol and rtol), the reference's kernel
tolerance (``tests/test_kernels.py``): both sides sum in float32 in
another order (a loop against an associative scan).  The model in float32
within 1e-4, greedy tokens equal; in bfloat16 within 2e-2 of the logits'
scale (the frameworks round bf16 at different places).  The card test
decides inside a fixture whether there is a card and skips with the reason
when there is none (the kernel is CUDA C++: it has no interpret mode).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.kernels.mamba_scan.kernel import mamba_scan_pallas
from repro.kernels.mamba_scan.ref import mamba_scan_ref as j_scan_ref
from repro.models import blocks as JB
from repro.models import model as JM
from repro.serve.engine import ServeEngine as JEngine
from repro_torch import convert
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.kernels.mamba_scan import ops as scan_ops
from repro_torch.kernels.mamba_scan.ref import mamba_scan_ref
from repro_torch.models import blocks as TB
from repro_torch.models import model as TM
from repro_torch.serve.engine import ServeEngine as TEngine

ARCH = "falcon-mamba-7b"
TOL = 1e-4
LEAVES = ("in_proj", "conv_w", "conv_b", "x_proj", "dt_proj", "dt_bias",
          "A_log", "D_skip", "out_proj")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel is CUDA C++ with no "
                    "interpret mode (python3 chip_smoke.py runs it)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def scan_inputs(seed, B, S, D, N):
    """Seeded numpy inputs as the reference's kernel test draws them:
    u, B, C normal, dt a softplus of a normal shifted by -1, A = -exp of a
    normal."""
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((B, S, D)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, D)) - 1.0)
                  ).astype(np.float32)
    bm = rng.standard_normal((B, S, N)).astype(np.float32)
    cm = rng.standard_normal((B, S, N)).astype(np.float32)
    A = -np.exp(rng.standard_normal((D, N))).astype(np.float32)
    return u, dt, bm, cm, A


def span_inputs(seed, B, S, D, N):
    """Inputs whose decays exp(dt A) span ~1e-8 to ~1: A = -(1..N) on
    every channel (the model's init) and dt log-uniform in [1e-6, 1.15],
    so that one carry vanishes within a step and another survives the
    whole sequence."""
    u, _, bm, cm, _ = scan_inputs(seed, B, S, D, N)
    rng = np.random.default_rng(seed + 7)
    dt = np.exp(rng.uniform(np.log(1e-6), np.log(1.15), (B, S, D))
                ).astype(np.float32)
    A = -np.tile(np.arange(1, N + 1, dtype=np.float32), (D, 1))
    return u, dt, bm, cm, A


def torch_of(arrays):
    return [torch.from_numpy(a) for a in arrays]


def close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


# ---------------------------------------------------------------------------
# the scan: plain version against the reference


@pytest.mark.parametrize("against", ["ref", "pallas"])
@pytest.mark.parametrize("S,D,N", [(256, 32, 4), (256, 64, 8), (128, 32, 16)])
def test_plain_scan_against_reference(S, D, N, against):
    arrays = scan_inputs(S * D + N, 2, S, D, N)
    j = [jnp.asarray(a) for a in arrays]
    if against == "ref":
        want = j_scan_ref(*j)
    else:
        want = mamba_scan_pallas(*j, bd=32, bs=128, interpret=True)
    y, h = mamba_scan_ref(*torch_of(arrays))
    assert y.shape == (2, S, D) and h.shape == (2, D, N)
    assert y.dtype == h.dtype == torch.float32
    close(y.numpy(), want)


@pytest.mark.parametrize("span", [False, True])
@pytest.mark.parametrize("S", [63, 64, 65, 129])
def test_plain_scan_at_chunk_edges(S, span):
    """The card kernel scans 64-step chunks: one step short of a chunk, a
    chunk, one past it and two chunks and one, at D=64 and B=2, with the
    reference's inputs and with decays spanning 1e-8..1, against the
    reference's oracle."""
    make = span_inputs if span else scan_inputs
    arrays = make(S + 3, 2, S, 64, 16)
    if span:
        decay = np.exp(arrays[1][..., None] * arrays[4])
        assert decay.min() < 1e-7 and decay.max() > 0.999
    want_y = j_scan_ref(*[jnp.asarray(a) for a in arrays])
    y, h = mamba_scan_ref(*torch_of(arrays))
    assert torch.isfinite(y).all() and torch.isfinite(h).all()
    close(y.numpy(), want_y)


def test_plain_scan_ragged_length():
    """S = 77 is no multiple of any block: against the oracle alone (the
    Pallas kernel needs whole blocks)."""
    arrays = scan_inputs(77, 2, 77, 32, 16)
    want = j_scan_ref(*[jnp.asarray(a) for a in arrays])
    y, _ = scan_ops.mamba_scan(*torch_of(arrays))
    close(y.numpy(), want)


@pytest.mark.parametrize("S", [1, 77, 300])
def test_h_last_matches_linear_recurrence(S):
    """The final state is the reference's ``linear_recurrence`` second
    output on the same decay and input (what its prefill keeps)."""
    u, dt, bm, cm, A = scan_inputs(S + 1, 2, S, 32, 8)
    decay = jnp.exp(jnp.asarray(dt)[..., None] * jnp.asarray(A))
    inp = (jnp.asarray(dt) * jnp.asarray(u))[..., None] * \
        jnp.asarray(bm)[:, :, None, :]
    hs, h_last = JB.linear_recurrence(decay, inp,
                                      jnp.zeros((2, 32, 8), jnp.float32),
                                      chunk=min(256, max(16, S)))
    y, h = scan_ops.mamba_scan(*torch_of((u, dt, bm, cm, A)))
    close(h.numpy(), h_last)
    close(y.numpy(), jnp.einsum("bsdn,bsn->bsd", hs, jnp.asarray(cm)))


def test_state_carries_across_the_whole_sequence():
    """The reference's carry test (``tests/test_kernels.py:138-151``): with
    decay ~1 and constant input, y grows linearly over all 512 steps."""
    B, S, D, N = 1, 512, 32, 4
    y, h = scan_ops.mamba_scan(torch.ones((B, S, D)),
                               torch.full((B, S, D), 1e-3),
                               torch.ones((B, S, N)), torch.ones((B, S, N)),
                               torch.full((D, N), -1e-6))
    yt = y[0, :, 0].numpy()
    assert (np.diff(yt) > 0).all()
    np.testing.assert_allclose(yt[-1] / yt[127], S / 128.0, rtol=1e-2)
    np.testing.assert_allclose(h.numpy(), 512 * 1e-3, rtol=1e-3)


def test_strided_bm_cm_views():
    """B and C as column slices of one (B, S, R + 2N) tensor, as the model
    splits its ``x_proj`` output: the same result as contiguous copies,
    and the reference's."""
    R, N = 8, 16
    u, dt, _, _, A = scan_inputs(5, 2, 99, 32, N)
    dbc = np.random.default_rng(6).standard_normal(
        (2, 99, R + 2 * N)).astype(np.float32)
    t_dbc = torch.from_numpy(dbc)
    _, bm, cm = t_dbc.split([R, N, N], dim=-1)
    assert not bm.is_contiguous() and not cm.is_contiguous()
    tu, tdt, tA = torch_of((u, dt, A))
    y, h = scan_ops.mamba_scan(tu, tdt, bm, cm, tA)
    y2, h2 = scan_ops.mamba_scan(tu, tdt, bm.contiguous(), cm.contiguous(),
                                 tA)
    close(y.numpy(), y2.numpy(), 1e-6)
    close(h.numpy(), h2.numpy(), 1e-6)
    want = j_scan_ref(jnp.asarray(u), jnp.asarray(dt),
                      jnp.asarray(dbc[..., R:R + N]),
                      jnp.asarray(dbc[..., R + N:]), jnp.asarray(A))
    close(y.numpy(), want)


@pytest.mark.parametrize("S", [1, 2, 9])
def test_causal_conv_and_conv_step_match_the_reference(S):
    """The depthwise causal conv over a sequence, and one conv step against
    a state of W-1 rows, within 1e-6 of the reference's."""
    rng = np.random.default_rng(S)
    u = rng.standard_normal((2, S, 8)).astype(np.float32)
    w = rng.standard_normal((4, 8)).astype(np.float32)
    b = rng.standard_normal((8,)).astype(np.float32)
    state = rng.standard_normal((2, 3, 8)).astype(np.float32)
    close(TB.causal_conv(*torch_of((u, w, b))).numpy(),
          JB.causal_conv(jnp.asarray(u), jnp.asarray(w), jnp.asarray(b)),
          1e-6)
    ty, ts = TB.conv_step(*torch_of((state, u[:, :1], w, b)))
    jy, js = JB.conv_step(jnp.asarray(state), jnp.asarray(u[:, :1]),
                          jnp.asarray(w), jnp.asarray(b))
    close(ty.numpy(), jy, 1e-6)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_ops_wrapper_cpu_counts_no_launch_and_validates():
    before = scan_ops.mamba_scan.launches
    u = torch.zeros((1, 4, 8))
    bm = torch.zeros((1, 4, 2))
    A = torch.zeros((8, 2))
    scan_ops.mamba_scan(u, u, bm, bm, A)
    assert scan_ops.mamba_scan.launches == before
    with pytest.raises(ValueError, match="do not agree"):
        scan_ops.mamba_scan(u, u, bm, bm, torch.zeros((7, 2)))
    with pytest.raises(ValueError, match="float32"):
        scan_ops.mamba_scan(u.double(), u, bm, bm, A)
    with pytest.raises(ValueError, match="empty"):
        scan_ops.mamba_scan(u[:, :0], u[:, :0], bm[:, :0], bm[:, :0], A)
    with pytest.raises(ValueError, match="want u"):
        scan_ops.mamba_scan(u[0], u, bm, bm, A)


# ---------------------------------------------------------------------------
# the model at smoke size


@pytest.fixture(scope="module")
def pair():
    jcfg, tcfg = j_smoke(ARCH), t_smoke(ARCH)
    jp = JM.init_params(jcfg, jax.random.key(0))
    tp = convert.params_from_numpy(tcfg, jax.device_get(jp), "cpu")
    return jcfg, tcfg, jp, tp


def tree_close(j, t, tol=TOL, of_scale=False):
    fj = {k: np.asarray(v, np.float32)
          for k, v in convert.flatten(jax.device_get(j)).items()}
    ft = convert.flatten(convert.state_to_numpy(t))
    assert fj.keys() == ft.keys(), fj.keys() ^ ft.keys()
    for k in fj:
        assert fj[k].shape == ft[k].shape, k
        if of_scale:
            assert np.abs(ft[k] - fj[k]).max() <= tol * np.abs(fj[k]).max(), k
        else:
            np.testing.assert_allclose(ft[k], fj[k], atol=tol, rtol=tol,
                                       err_msg=k)


def test_params_from_numpy_carries_the_mamba_leaves(pair):
    jcfg, tcfg, jp, tp = pair
    sd = tp.state_dict()
    mixer = jax.device_get(jp)["units"]["p0"]["mixer"]
    assert set(mixer) == set(LEAVES)
    for name in LEAVES:
        for u in range(tcfg.n_units):
            got = sd[f"units.p0.{u}.mixer.{name}"]
            assert got.dtype == torch.float32, name
            np.testing.assert_array_equal(got.numpy(), mixer[name][u])


def test_seeded_init_matches_the_reference_init():
    """The port's own init draws the reference's distributions and sets
    its constants (A_log = log(1..N), D_skip = 1, conv_b = 0, dt_bias the
    inverse softplus of a step in [1e-3, 1e-1])."""
    cfg = t_smoke(ARCH)
    p = TM.init_params(cfg, seed=2, device="cpu").state_dict()
    jp = convert.flatten(jax.device_get(
        JM.init_params(j_smoke(ARCH), jax.random.key(2))))
    for name in ("A_log", "D_skip", "conv_b"):
        np.testing.assert_array_equal(p[f"units.p0.0.mixer.{name}"].numpy(),
                                      jp[f"units/p0/mixer/{name}"][0])
    step = torch.nn.functional.softplus(p["units.p0.0.mixer.dt_bias"])
    assert (step >= 1e-3 - 1e-7).all() and (step <= 1e-1 + 1e-7).all()
    w = p["units.p0.0.mixer.in_proj"].numpy()
    assert np.abs(w).max() <= 2.0 / np.sqrt(cfg.d_model) + 1e-7
    np.testing.assert_allclose(w.std(), jp["units/p0/mixer/in_proj"].std(),
                               rtol=0.1)


def test_train_forward_logits(pair):
    jcfg, tcfg, jp, tp = pair
    toks = np.random.default_rng(2).integers(0, jcfg.vocab, (2, 19)
                                             ).astype(np.int32)
    jl = JM.forward(jcfg, jp, {"tokens": jnp.asarray(toks)})
    tl = TM.forward(tcfg, tp, {"tokens": torch.from_numpy(toks)})
    close(tl.numpy(), jl)


@pytest.mark.parametrize("S", [1, 2, 3, 13, 300])
def test_prefill_logits_and_cache(pair, S):
    """Logits and the cache (``h``; ``conv`` with min(S, W-1) rows, as
    the reference keeps it) within 1e-4; S = 300 runs more than one of the
    reference's 256-step scan chunks."""
    jcfg, tcfg, jp, tp = pair
    toks = np.random.default_rng(S).integers(0, jcfg.vocab, (2, S)
                                             ).astype(np.int32)
    jl, jc = JM.prefill(jcfg, jp, {"tokens": jnp.asarray(toks)})
    tl, tc = TM.prefill(tcfg, tp, {"tokens": torch.from_numpy(toks)})
    close(tl.numpy(), jl)
    np.testing.assert_array_equal(
        TM.greedy_token(tcfg, tl).numpy(),
        np.asarray(JM.greedy_token(jcfg, jl)))
    assert tc["units"]["p0"]["conv"].shape[2] == min(S, tcfg.conv_width - 1)
    tree_close(jc, tc)


def test_decode_steps_follow_the_reference(pair):
    """Prefill two prompts, then 4 decode steps in both packages: logits
    and the in-place updated cache within 1e-4 after every step, greedy
    tokens equal."""
    jcfg, tcfg, jp, tp = pair
    toks = np.random.default_rng(3).integers(0, jcfg.vocab, (2, 7)
                                             ).astype(np.int32)
    jl, jc = JM.prefill(jcfg, jp, {"tokens": jnp.asarray(toks)})
    tl, tc = TM.prefill(tcfg, tp, {"tokens": torch.from_numpy(toks)})
    pos = np.array([7, 7], np.int32)
    for _ in range(4):
        jt = JM.greedy_token(jcfg, jl)
        tt = TM.greedy_token(tcfg, tl)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        jl, jc = JM.decode_step(jcfg, jp, jc, jt, jnp.asarray(pos))
        before = tc
        tl, tc = TM.decode_step(tcfg, tp, tc, tt, torch.from_numpy(pos))
        assert tc is before                       # updated in place
        close(tl.numpy(), jl)
        tree_close(jc, tc)
        pos = pos + 1


def test_decode_write_mask_keeps_the_state_bit_for_bit(pair):
    """``write`` unset on a row leaves its ``h`` and ``conv`` bit-unchanged
    (the serving tile's skipped step); the row that writes equals a step
    with no mask."""
    jcfg, tcfg, jp, tp = pair
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, tcfg.vocab, (2, 5)).astype(np.int32))
    _, cache = TM.prefill(tcfg, tp, {"tokens": toks})
    free = {k: t.clone() for k, t in cache["units"]["p0"].items()}
    masked = {k: t.clone() for k, t in cache["units"]["p0"].items()}
    tok, pos = torch.tensor([3, 4], dtype=torch.int32), torch.tensor([5, 5])
    l_free, _ = TM.decode_step(tcfg, tp, {"units": {"p0": free}, "rem": []},
                               tok, pos)
    l_mask, _ = TM.decode_step(tcfg, tp, {"units": {"p0": masked},
                                          "rem": []}, tok, pos,
                               write=torch.tensor([True, False]))
    assert torch.equal(l_free, l_mask)       # the output does not depend on it
    for k in ("h", "conv"):
        assert torch.equal(masked[k][:, 1], cache["units"]["p0"][k][:, 1]), k
        assert torch.equal(masked[k][:, 0], free[k][:, 0]), k
        assert not torch.equal(free[k][:, 1], cache["units"]["p0"][k][:, 1])
    # a scalar False keeps every row
    kept = {k: t.clone() for k, t in cache["units"]["p0"].items()}
    TM.decode_step(tcfg, tp, {"units": {"p0": kept}, "rem": []}, tok, pos,
                   write=torch.tensor(False))
    for k in ("h", "conv"):
        assert torch.equal(kept[k], cache["units"]["p0"][k]), k


def test_prefill_then_decode_equals_a_longer_prefill(pair):
    """The port against itself: P tokens of prefill and one decode step
    give the logits and state of a prefill of P + 1 tokens (the scan and
    the recurrence step agree)."""
    _, tcfg, _, tp = pair
    toks = torch.from_numpy(np.random.default_rng(9).integers(
        0, tcfg.vocab, (1, 12)).astype(np.int32))
    _, cache = TM.prefill(tcfg, tp, {"tokens": toks[:, :11]})
    l_dec, cache = TM.decode_step(tcfg, tp, cache, toks[:, 11],
                                  torch.tensor([11]))
    l_pre, want = TM.prefill(tcfg, tp, {"tokens": toks})
    close(l_dec.numpy(), l_pre.numpy())
    for k in ("h", "conv"):
        close(cache["units"]["p0"][k].numpy(),
              want["units"]["p0"][k].numpy())


def test_bf16_compute_within_2e2():
    jcfg = j_smoke(ARCH, compute_dtype="bfloat16")
    tcfg = t_smoke(ARCH, compute_dtype="bfloat16")
    jp = JM.init_params(jcfg, jax.random.key(0))
    tp = convert.params_from_numpy(tcfg, jax.device_get(jp), "cpu")
    toks = np.random.default_rng(6).integers(0, jcfg.vocab, (2, 11)
                                             ).astype(np.int32)
    jl, jc = JM.prefill(jcfg, jp, {"tokens": jnp.asarray(toks)})
    tl, tc = TM.prefill(tcfg, tp, {"tokens": torch.from_numpy(toks)})
    assert tl.dtype == torch.bfloat16
    assert tc["units"]["p0"]["h"].dtype == torch.float32
    tl, jl = tl.float().numpy(), np.asarray(jl, np.float32)
    assert np.abs(tl - jl).max() <= 2e-2 * np.abs(jl).max()
    assert (tl.argmax(-1) == jl.argmax(-1)).all()
    tree_close(jc, tc, 2e-2, of_scale=True)
    tok = jnp.asarray(np.argmax(jl, -1).astype(np.int32))
    pos = np.array([11, 11], np.int32)
    jl2, jc2 = JM.decode_step(jcfg, jp, jc, tok, jnp.asarray(pos))
    tl2, tc2 = TM.decode_step(tcfg, tp, tc, torch.from_numpy(np.array(tok)),
                              torch.from_numpy(pos))
    tl2, jl2 = tl2.float().numpy(), np.asarray(jl2, np.float32)
    assert np.abs(tl2 - jl2).max() <= 2e-2 * np.abs(jl2).max()
    tree_close(jc2, tc2, 2e-2, of_scale=True)


# ---------------------------------------------------------------------------
# the serving engine


def test_engine_sessions_and_migration_match_the_reference(pair):
    """Three sessions of prompt lengths 5, 1 and 3 (1 fills the conv rows
    by broadcasting, 3 = W-1 exactly), generation, release and a new
    session in the freed slot, and a session migrated mid-generation:
    tokens equal to the reference's engine, caches within 1e-4."""
    jcfg, tcfg, jp, tp = pair
    rng = np.random.default_rng(10)
    prompts = [rng.integers(0, jcfg.vocab, n).astype(np.int32)
               for n in (5, 1, 3)]
    je = JEngine(jcfg, jp, max_sessions=3, max_seq=32)
    te = TEngine(tcfg, tp, max_sessions=3, max_seq=32)
    for pr in prompts:
        assert je.new_session(pr) == te.new_session(pr)
    tree_close(je.cache, te.cache)
    for sid in range(3):
        assert je.generate(sid, 3) == te.generate(sid, 3)
    tree_close(je.cache, te.cache)

    je.release(1)
    te.release(1)
    fresh = rng.integers(0, jcfg.vocab, 4).astype(np.int32)
    assert je.new_session(fresh) == te.new_session(fresh) == 1
    assert je.generate(1, 4) == te.generate(1, 4)
    tree_close(je.cache, te.cache)

    # migrate session 0 to a second engine mid-generation
    jb = JEngine(jcfg, jp, max_sessions=3, max_seq=32)
    tb = TEngine(tcfg, tp, max_sessions=3, max_seq=32)
    jsid = jb.migrate_in(je.migrate_out(0))
    tsid = tb.migrate_in(te.migrate_out(0))
    assert jsid == tsid == 0 and not te.used[0]
    assert jb.generate(jsid, 3) == tb.generate(tsid, 3)
    tree_close(jb.cache, tb.cache)


def test_one_token_prompt_broadcasts_into_the_conv_state(pair):
    """The reference's install broadcasts a 1-token prompt's single
    pre-conv input into all W-1 conv rows (the causal state would be
    zeros, then the input): the port does the same."""
    jcfg, tcfg, jp, tp = pair
    prompt = np.array([17], np.int32)
    je = JEngine(jcfg, jp, max_sessions=2, max_seq=16)
    te = TEngine(tcfg, tp, max_sessions=2, max_seq=16)
    je.new_session(prompt)
    te.new_session(prompt)
    tree_close(je.cache, te.cache)
    for conv in (np.asarray(je.cache["units"]["p0"]["conv"][:, 0]),
                 te.cache["units"]["p0"]["conv"][:, 0].numpy()):
        assert conv.shape[1] == tcfg.conv_width - 1
        assert np.abs(conv[:, 0]).max() > 0
        for row in range(1, conv.shape[1]):
            np.testing.assert_array_equal(conv[:, row], conv[:, 0])
    assert je.generate(0, 3) == te.generate(0, 3)


def test_two_token_prompt_is_refused_as_by_the_reference(pair):
    """A prompt of 2 tokens (1 < P < W-1) leaves a conv state of 2 rows
    that does not broadcast into the slot's 3: the reference's install
    raises, and the port's raises a ValueError naming that limit and
    leaves the engine as it was."""
    jcfg, tcfg, jp, tp = pair
    prompt = np.array([5, 6], np.int32)
    je = JEngine(jcfg, jp, max_sessions=2, max_seq=16)
    with pytest.raises(ValueError, match="Incompatible shapes"):
        je.new_session(prompt)
    te = TEngine(tcfg, tp, max_sessions=2, max_seq=16)
    before = {k: t.clone() for k, t in convert.flatten(te.cache).items()}
    with pytest.raises(ValueError, match="installs only when it has 1 token"):
        te.new_session(prompt)
    assert not te.used.any()
    for k, t in convert.flatten(te.cache).items():
        assert torch.equal(t, before[k]), k
    assert te.new_session(np.array([5, 6, 7], np.int32)) == 0


# ---------------------------------------------------------------------------
# on the card


CARD_CASES = [  # (B, S, D, decays spanning 1e-8..1)
    (2, 1, 96, False), (2, 3, 96, False), (2, 129, 96, False),
    (2, 300, 96, False),
    # the kernel's 64-step chunks: one short, one, one past, two and one;
    # D = 98 leaves a block's last warp with 2 of its 4 channels
    (1, 63, 98, False), (1, 64, 98, False), (1, 65, 98, False),
    (2, 129, 98, False), (2, 129, 96, True), (1, 2000, 98, True)]


@pytest.mark.parametrize("B,S,D,span", CARD_CASES)
def test_mamba_kernel_on_card(cuda, B, S, D, span):
    """The CUDA kernel against its plain version on the card, with B and C
    as strided column views, within 1e-4."""
    R, N = 16, 16
    u, dt, _, _, A = (span_inputs if span else scan_inputs)(S, B, S, D, N)
    dbc = torch.from_numpy(np.random.default_rng(S + 1).standard_normal(
        (B, S, R + 2 * N)).astype(np.float32)).to(cuda)
    _, bm, cm = dbc.split([R, N, N], dim=-1)
    tu, tdt, tA = (t.to(cuda) for t in torch_of((u, dt, A)))
    before = scan_ops.mamba_scan.launches
    y, h = scan_ops.mamba_scan(tu, tdt, bm, cm, tA)
    torch.cuda.synchronize()
    assert scan_ops.mamba_scan.launches == before + 1
    wy, wh = mamba_scan_ref(tu, tdt, bm, cm, tA)
    close(y.cpu().numpy(), wy.cpu().numpy())
    close(h.cpu().numpy(), wh.cpu().numpy())
