"""The port's model against the reference at smoke size: the JAX package's
initialised parameters, carried across with ``convert.params_from_numpy``,
and the same seeded numpy inputs go through both packages.

Configs: qwen1.5-0.5b (GQA G=2, QKV bias — the serving model),
internlm2-1.8b (untied LM head) and gemma3-12b (sliding-window layers with
a rolling cache, qk-norm, embedding scale, GeGLU).  In float32 logits and
caches agree within 1e-4 and greedy tokens are equal; in bfloat16 within
2e-2 of the largest logit or cache entry (the two frameworks round
bf16 at different places, and the port's prefill attention keeps its
softmax weights in float32 where the reference's ``_attn_dense`` rounds
them to bf16).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.models import layers as JL
from repro.models import model as JM
from repro.sharding import SINGLE
from repro_torch import convert
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.models import layers as TL
from repro_torch.models import model as TM

ARCHS = ["qwen1.5-0.5b", "internlm2-1.8b", "gemma3-12b"]


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    arch = request.param
    jcfg, tcfg = j_smoke(arch), t_smoke(arch)
    jp = JM.init_params(jcfg, jax.random.key(0))
    tp = convert.params_from_numpy(tcfg, jax.device_get(jp), "cpu")
    return jcfg, tcfg, jp, tp


def flat(tree):
    return {k: np.asarray(v, np.float32)
            for k, v in convert.flatten(jax.device_get(tree)).items()}


def assert_close_tree(j, t, tol, of_scale=False):
    """Leaf by leaf within ``tol`` (elementwise, or with ``of_scale`` as a
    share of the leaf's largest magnitude)."""
    fj, ft = flat(j), convert.flatten(convert.state_to_numpy(t))
    assert fj.keys() == ft.keys(), fj.keys() ^ ft.keys()
    for k in fj:
        assert fj[k].shape == ft[k].shape, k
        if of_scale:
            assert np.abs(ft[k] - fj[k]).max() <= tol * np.abs(fj[k]).max(), k
        else:
            np.testing.assert_allclose(ft[k], fj[k], atol=tol, rtol=tol,
                                       err_msg=k)


def logits_close(tl, jl, tol):
    tl, jl = tl.float().numpy(), np.asarray(jl, np.float32)
    np.testing.assert_allclose(tl, jl, atol=tol, rtol=tol)
    return tl, jl


# ---------------------------------------------------------------------------
# parameters


def test_params_carry_the_reference_paths(pair):
    jcfg, tcfg, jp, tp = pair
    sd = tp.state_dict()
    fj = convert.flatten(jax.device_get(jp))
    want = set()
    for path, leaf in fj.items():
        parts = path.split("/")
        if parts[0] == "units":        # stacked over units: one key a layer
            for u in range(tcfg.n_units):
                key = ".".join(parts[:2] + [str(u)] + parts[2:])
                want.add(key)
                np.testing.assert_array_equal(sd[key].numpy(), leaf[u])
        else:
            want.add(".".join(parts))
            np.testing.assert_array_equal(sd[".".join(parts)].numpy(), leaf)
    assert set(sd) == want
    assert all(not p.requires_grad for p in tp.parameters())


def test_seeded_init_matches_the_reference_distributions():
    cfg = t_smoke("qwen1.5-0.5b")
    a = TM.init_params(cfg, seed=3, device="cpu")
    b = TM.init_params(cfg, seed=3, device="cpu")
    jp = JM.init_params(j_smoke("qwen1.5-0.5b"), jax.random.key(3))
    ja = convert.flatten(jax.device_get(jp))
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    wq = sa["units.p0.0.mixer.wq"].numpy()
    # truncated normal at +-2 sigma, scaled by 1/sqrt(fan_in)
    assert np.abs(wq).max() <= 2.0 / np.sqrt(cfg.d_model) + 1e-7
    np.testing.assert_allclose(wq.std(), ja["units/p0/mixer/wq"].std(),
                               rtol=0.1)
    assert (sa["units.p0.0.mixer.bq"] == 0).all()
    assert (sa["final_norm.scale"] == 1).all()
    if not torch.cuda.is_available():       # the entry point's default
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            TM.init_params(cfg)


# ---------------------------------------------------------------------------
# prefill, train-mode forward, decode


def test_prefill_logits_and_cache(pair):
    jcfg, tcfg, jp, tp = pair
    toks = np.random.default_rng(1).integers(0, jcfg.vocab, (2, 13)
                                             ).astype(np.int32)
    jl, jc = JM.prefill(jcfg, jp, {"tokens": jnp.asarray(toks)})
    tl, tc = TM.prefill(tcfg, tp, {"tokens": torch.from_numpy(toks)})
    tl, jl = logits_close(tl, jl, 1e-4)
    np.testing.assert_array_equal(
        TM.greedy_token(tcfg, torch.from_numpy(tl)).numpy(),
        np.asarray(JM.greedy_token(jcfg, jnp.asarray(jl))))
    assert_close_tree(jc, tc, 1e-4)


def test_train_forward_logits(pair):
    jcfg, tcfg, jp, tp = pair
    toks = np.random.default_rng(2).integers(0, jcfg.vocab, (2, 9)
                                             ).astype(np.int32)
    jl = JM.forward(jcfg, jp, {"tokens": jnp.asarray(toks)})
    tl = TM.forward(tcfg, tp, {"tokens": torch.from_numpy(toks)})
    logits_close(tl, jl, 1e-4)


def random_cache(jcfg, M, S, seed):
    rng = np.random.default_rng(seed)
    shapes = jax.device_get(JM.init_cache(jcfg, M, S))
    return jax.tree.map(lambda x: (rng.standard_normal(x.shape) * 0.5
                                   ).astype(np.float32).astype(x.dtype),
                        shapes)


def test_decode_step_per_session_positions(pair):
    """One decode step at per-session positions, one of them at
    ``pos == max_seq``: the reference drops that row's cache write, the
    port masks it."""
    jcfg, tcfg, jp, tp = pair
    M, S = 3, 16
    cache = random_cache(jcfg, M, S, 4)
    rng = np.random.default_rng(5)
    tok = rng.integers(0, jcfg.vocab, (M,)).astype(np.int32)
    pos = np.array([3, S, 9], np.int32)
    jl, jc = JM.decode_step(jcfg, jp, jax.tree.map(jnp.asarray, cache),
                            jnp.asarray(tok), jnp.asarray(pos))
    tcache = convert.state_from_numpy(cache, "cpu")
    tl, tc = TM.decode_step(tcfg, tp, tcache, torch.from_numpy(tok),
                            torch.from_numpy(pos))
    assert tc is tcache                       # updated in place
    tl, jl = logits_close(tl, jl, 1e-4)
    assert (tl.argmax(-1) == jl.argmax(-1)).all()
    assert_close_tree(jc, tc, 1e-4)


def test_cache_write_at_max_seq_is_dropped():
    """The global-attention cache row at ``pos == max_seq`` does not exist:
    the write is dropped and every other row keeps its value bit for bit;
    a row with ``write`` unset keeps its old value too."""
    cache = torch.arange(2 * 4 * 1 * 2, dtype=torch.float32).reshape(
        2, 4, 1, 2)
    before = cache.clone()
    new = torch.full((2, 1, 2), -1.0)
    TL._cache_write(cache, new, torch.tensor([4, 1]), None)
    want = before.clone()
    want[1, 1] = -1.0
    assert torch.equal(cache, want)
    TL._cache_write(cache, new * 2, torch.tensor([0, 2]),
                    torch.tensor([True, False]))
    want[0, 0] = -2.0
    assert torch.equal(cache, want)


def test_bf16_compute_within_2e2():
    jcfg = j_smoke("qwen1.5-0.5b", compute_dtype="bfloat16")
    tcfg = t_smoke("qwen1.5-0.5b", compute_dtype="bfloat16")
    jp = JM.init_params(jcfg, jax.random.key(0))
    tp = convert.params_from_numpy(tcfg, jax.device_get(jp), "cpu")
    toks = np.random.default_rng(6).integers(0, jcfg.vocab, (2, 11)
                                             ).astype(np.int32)
    jl, jc = JM.prefill(jcfg, jp, {"tokens": jnp.asarray(toks)})
    tl, tc = TM.prefill(tcfg, tp, {"tokens": torch.from_numpy(toks)})
    assert tl.dtype == torch.bfloat16
    # 2e-2 of the logits' scale: bf16 keeps 8 bits, and the frameworks
    # round at different places, so single logits differ by a few units
    # in the last place of the largest one
    tl, jl = tl.float().numpy(), np.asarray(jl, np.float32)
    assert np.abs(tl - jl).max() <= 2e-2 * np.abs(jl).max()
    assert (tl.argmax(-1) == jl.argmax(-1)).all()
    assert_close_tree(jc, tc, 2e-2, of_scale=True)


# ---------------------------------------------------------------------------
# embedding edge cases and refusals


def test_embedding_out_of_range_tokens_match_jnp_take():
    cfg = t_smoke("qwen1.5-0.5b")
    jcfg = j_smoke("qwen1.5-0.5b")
    table = np.random.default_rng(7).standard_normal(
        (cfg.v_pad, cfg.d_model)).astype(np.float32)
    toks = np.array([[0, 5, cfg.v_pad - 1, cfg.v_pad, 65535, -1,
                      -cfg.v_pad - 1]], np.int32)
    want = np.asarray(JL.embed_apply(jcfg, {"table": jnp.asarray(table)},
                                     jnp.asarray(toks), SINGLE))
    got = TL.embed_apply(cfg, {"table": torch.from_numpy(table)},
                         torch.from_numpy(toks)).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(got[~np.isnan(got)], want[~np.isnan(want)])
    assert np.isnan(got[0, 3]).all() and np.isnan(got[0, 4]).all()


@pytest.mark.parametrize("arch,what", [
    ("olmoe-1b-7b", "MoE"), ("recurrentgemma-2b", "RG-LRU")])
def test_unported_mixers_refuse_by_name(arch, what):
    with pytest.raises(NotImplementedError, match=what):
        TM.init_params(t_smoke(arch), device="cpu")


@pytest.mark.parametrize("arch,over,what", [
    ("hubert-xlarge", {}, "audio_stub front end"),
    ("internvl2-2b", {}, "vision_stub front end"),
    ("qwen1.5-0.5b", {"attn_impl": "iso"}, "iso"),
    ("falcon-mamba-7b", {"ssm_scan_dtype": "bfloat16"},
     "ssm_scan_dtype='bfloat16'.*item 12"),
    ("falcon-mamba-7b", {"ssm_impl": "noscan"}, "ssm_impl='noscan'.*item 12")])
def test_unported_options_refuse_by_name(arch, over, what):
    cfg = t_smoke(arch, **over)
    params = TM.init_params(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match=what):
        TM.forward(cfg, params, {"tokens": torch.zeros((1, 4),
                                                       dtype=torch.int64)})


def test_training_refuses_by_name():
    cfg = t_smoke("qwen1.5-0.5b")
    with pytest.raises(NotImplementedError, match="item 12"):
        TM.loss_fn(cfg, None, {})
    with pytest.raises(NotImplementedError, match="item 12"):
        TL.cross_entropy(cfg, None, None)
