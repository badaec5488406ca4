"""The port's LM serving against the reference at smoke size (the serving
model of ``configs/serve_smoke.py``, qwen1.5-0.5b reduced, float32): the
JAX package's parameters carried across with ``convert.params_from_numpy``.

  * ``ServeEngine``: generate, release and live migration give the
    reference's tokens;
  * ``LmServerApp.handle``: the reply bytes equal the reference's for new
    sessions, follow-ups, unknown sessions, truncated requests, releases,
    LRU eviction and a prompt token outside the vocabulary;
  * the ``lm_serve`` tile through ``UdpStack.run_stream`` (reference with
    ``with_obs=False``): a stream holding valid, duplicate, unknown-session
    and truncated requests, a batch with no LM request, and a session that
    runs out of room (its cache row at ``pos == max_seq`` is dropped).
    Reply bytes, lengths, alive and info masks and the integer state equal
    the reference's bit for bit, the cache within 1e-4; the stream equals
    sequential ``rx_tx`` calls and the port's own ``ServeEngine`` tokens
    exactly, and a batch with no LM request leaves the cache unchanged;
  * token ids above 0xFFFF (qwen1.5's full vocabulary) travel as their low
    16 bits, the wire's u16, while the tile's state keeps the whole id.
"""
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.apps import lm_server as j_lm
from repro.configs.serve_smoke import serve_config as j_serve_config
from repro.models import model as JM
from repro.net import frames as F, rpc as jrpc
from repro.net import stack as j_stack
from repro.serve.engine import ServeEngine as JEngine
from repro_torch import convert
from repro_torch.apps import lm_server as t_lm
from repro_torch.configs.serve_smoke import serve_config as t_serve_config
from repro_torch.net import stack as t_stack
from repro_torch.serve.engine import ServeEngine as TEngine

IP_C, IP_S = F.ip("10.0.0.2"), F.ip("10.0.0.1")
PORT = 9400
W = 160                      # frame width of the LM arenas


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = j_serve_config(), t_serve_config()
    jp = JM.init_params(jcfg, jax.random.key(0))
    tp = convert.params_from_numpy(tcfg, jax.device_get(jp), "cpu")
    return jcfg, tcfg, jp, tp


def lm_frame(session, req_id, n_gen=1, prompt=(), cut=None):
    body = j_lm.encode_request(session, n_gen, list(prompt))
    if cut is not None:
        body = body[:cut]
    return F.udp_rpc_frame(IP_C, IP_S, 5000 + req_id % 7, PORT,
                           jrpc.np_frame(jrpc.MSG_LM_GENERATE, req_id, body))


def reply_body(tx, txl):
    """The RPC body of one reply frame (eth 14 + ip 20 + udp 8 + rpc 9)."""
    assert txl >= 51
    plen = (int(tx[49]) << 8) | int(tx[50])
    return bytes(tx[51:51 + plen])


# ---------------------------------------------------------------------------
# the engine and the host-mediated app


def test_engine_generate_release_and_migration(models):
    jcfg, tcfg, jp, tp = models
    prompt = np.asarray([3, 1, 4, 1, 5], np.int32)
    je = JEngine(jcfg, jp, max_sessions=2, max_seq=32)
    te = TEngine(tcfg, tp, max_sessions=2, max_seq=32)
    jsid, tsid = je.new_session(prompt), te.new_session(prompt)
    assert jsid == tsid == 0
    want = je.generate(jsid, 6)
    got = te.generate(tsid, 6)
    assert got == want

    # release frees the slot; a new session there starts afresh
    te.release(tsid)
    assert te.has_free_slot() and int(te.pos[tsid]) == 0
    assert te.new_session(prompt) == tsid
    assert te.generate(tsid, 6) == want

    # migrate mid-generation: the continuation equals an unmigrated run
    a = TEngine(tcfg, tp, max_sessions=2, max_seq=32)
    b = TEngine(tcfg, tp, max_sessions=2, max_seq=32)
    sid = a.new_session(prompt)
    first = a.generate(sid, 2)
    app_a, app_b = t_lm.LmServerApp(a), t_lm.LmServerApp(b)
    app_a.session_map[99] = sid
    app_a.migrate_session_to(99, app_b)
    assert not a.used[sid] and 99 in app_b.session_map
    rest = b.generate(app_b.session_map[99], 4)
    assert first + rest == want


def test_lm_server_app_reply_bytes_equal_reference(models):
    jcfg, tcfg, jp, tp = models
    japp = j_lm.LmServerApp(JEngine(jcfg, jp, max_sessions=2, max_seq=32))
    tapp = t_lm.LmServerApp(TEngine(tcfg, tp, max_sessions=2, max_seq=32))
    reqs = [
        ("gen", j_lm.encode_request(7, 3, [5, 6, 7])),       # opens 7
        ("gen", j_lm.encode_request(7, 2, [])),              # follow-up
        ("gen", j_lm.encode_request(8, 1, [9, 9])),          # opens 8
        ("gen", j_lm.encode_request(777, 1, [])),            # unknown
        ("gen", j_lm.encode_request(9, 1, [1, 2])[:5]),      # truncated
        ("gen", j_lm.encode_request(9, 2, [300, 2])),        # LRU-evicts 7;
                                                             # token >= vocab
        ("gen", j_lm.encode_request(7, 1, [])),              # 7 was evicted
        ("rel", j_lm.encode_release(8)),
        ("rel", j_lm.encode_release(8)),                     # already gone
        ("rel", b"\x00"),                                    # truncated
        ("gen", j_lm.encode_request(10, 2, [4])),            # reuses 8's slot
    ]
    for kind, req in reqs:
        if kind == "gen":
            want, got = japp.handle(req), tapp.handle(req)
        else:
            want, got = japp.handle_release(req), tapp.handle_release(req)
        assert got == want, (kind, req)
        assert t_lm.decode_reply(got) == j_lm.decode_reply(want)
        assert t_lm.reply_error(got) == j_lm.reply_error(want)
    assert list(tapp.session_map) == list(japp.session_map)


# ---------------------------------------------------------------------------
# the direct-attached tile through the stack


def lm_stream_frames():
    """N=4 batches of B=6 frames.  Sessions 42, 43, 44; 43's prompt leaves
    it two steps of room in max_seq=12.  Batch 0: the error/coalescing mix
    (valid, duplicate, unknown session, truncated); batch 1: all three;
    batch 2: no LM request; batch 3: 43 is out of room."""
    junk = F.udp_rpc_frame(IP_C, IP_S, 5000, PORT,
                           jrpc.np_frame(jrpc.MSG_ECHO, 99, b"x"))
    batches = [
        [lm_frame(42, 0), lm_frame(43, 1), lm_frame(44, 2), lm_frame(42, 3),
         lm_frame(777, 4), lm_frame(43, 5, cut=4)],
        [lm_frame(44, 6), lm_frame(43, 7), lm_frame(42, 8), junk, junk,
         lm_frame(42, 9, n_gen=0)],
        [junk, junk, lm_frame(5, 10, cut=0), junk, junk, junk],
        [lm_frame(43, 11), lm_frame(42, 12), lm_frame(44, 13), junk,
         lm_frame(44, 14), junk],
    ]
    arena = F.FrameArena(len(batches), 6, W)
    arena.fill([f for b in batches for f in b])
    return arena


PROMPTS = {42: [1, 2, 3], 43: list(range(1, 11)), 44: [7, 5]}
M, S_MAX = 3, 12


def prefilled(eng):
    return {s: eng.new_session(np.asarray(p, np.int32))
            for s, p in PROMPTS.items()}


def test_lm_serve_stream_matches_reference_and_engine(models):
    jcfg, tcfg, jp, tp = models
    arena = lm_stream_frames()

    # reference
    je = JEngine(jcfg, jp, max_sessions=M, max_seq=S_MAX)
    jmap = prefilled(je)
    jtile = j_lm.make_tile(jcfg, jp, max_sessions=M, max_seq=S_MAX)
    js = j_stack.UdpStack([jtile], IP_S, with_obs=False,
                          topo=j_stack.rpc_serve_topology(
                              [("lm", "lm_serve", jrpc.MSG_LM_GENERATE)]))
    jstate = js.init_state()
    jstate["apps"]["lm"] = j_lm.adopt_engine(jstate["apps"]["lm"], je, jmap)
    jstate, jouts = js.run_stream(jstate, jnp.asarray(arena.payload),
                                  jnp.asarray(arena.length))

    # port
    te = TEngine(tcfg, tp, max_sessions=M, max_seq=S_MAX)
    tmap = prefilled(te)
    assert tmap == jmap
    ttile = t_lm.make_tile(tcfg, tp, max_sessions=M, max_seq=S_MAX)
    ts = t_stack.UdpStack([ttile], IP_S, device="cpu",
                          topo=t_stack.rpc_serve_topology(
                              [("lm", "lm_serve", jrpc.MSG_LM_GENERATE)]))
    t0 = ts.init_state()
    t0["apps"]["lm"] = t_lm.adopt_engine(t0["apps"]["lm"], te, tmap)
    tseq = convert.state_from_numpy(convert.state_to_numpy(t0))
    tstate, touts = ts.run_stream(t0, torch.from_numpy(arena.payload),
                                  torch.from_numpy(arena.length))

    # bit for bit against the reference: replies, masks, integer state
    for k in ("tx_payload", "tx_len", "alive"):
        np.testing.assert_array_equal(touts[k].numpy(), np.asarray(jouts[k]),
                                      err_msg=k)
    np.testing.assert_array_equal(touts["info"]["lm"].numpy(),
                                  np.asarray(jouts["info"]["lm"]))
    fj = convert.flatten(jax.device_get(jstate))
    ft = convert.flatten(convert.state_to_numpy(tstate))
    assert fj.keys() == ft.keys(), fj.keys() ^ ft.keys()
    for k in fj:
        want = np.asarray(fj[k])
        if want.dtype == np.uint32:
            want = want.astype(np.int64)
        if "cache" in k:
            np.testing.assert_allclose(ft[k], want, atol=1e-4, rtol=1e-4,
                                       err_msg=k)
        else:
            assert ft[k].dtype == want.dtype, k
            np.testing.assert_array_equal(ft[k], want, err_msg=k)

    # the replies: tokens, error sentinels, coalescing
    tx, txl = touts["tx_payload"].numpy(), touts["tx_len"].numpy()
    body = lambda b, i: reply_body(tx[b, i], txl[b, i])  # noqa: E731
    got = {s: [] for s in PROMPTS}
    for b, i in ((0, 0), (0, 1), (0, 2), (1, 2), (1, 1), (1, 0), (3, 1),
                 (3, 2)):
        s, toks, ok = t_lm.decode_reply(body(b, i))
        assert ok and len(toks) == 1 and t_lm.reply_error(body(b, i)) is None
        got[s] += toks
    assert body(0, 3) == body(0, 0)                   # duplicate coalesced
    assert body(3, 4) == body(3, 2)
    assert t_lm.reply_error(body(0, 4)) == t_lm.ERR_NO_SESSION
    assert t_lm.reply_error(body(0, 5)) == t_lm.ERR_BAD_REQUEST
    assert t_lm.reply_error(body(1, 5)) == t_lm.ERR_BAD_REQUEST   # n_gen 0
    assert t_lm.reply_error(body(2, 2)) == t_lm.ERR_BAD_REQUEST
    assert t_lm.reply_error(body(3, 0)) == t_lm.ERR_NO_SLOT       # no room
    st = tstate["apps"]["lm"]
    assert st["pos"].tolist() == [3 + 3, 10 + 2, 2 + 3]
    assert int(st["served"]) == 3 + 1 + 3 + 0 + 3
    assert not touts["info"]["lm"][2, [0, 1, 3, 4, 5]].any()

    # exactly the port's own engine: every session steps together there
    ref = TEngine(tcfg, tp, max_sessions=M, max_seq=S_MAX)
    rmap = prefilled(ref)
    steps = [ref.step() for _ in range(3)]
    for s, toks in got.items():
        n = len(toks)
        assert toks == [int(steps[k][rmap[s]]) for k in range(n)], s

    # sequential rx_tx calls give the same outputs and state
    for b in range(arena.payload.shape[0]):
        tseq, q, ql, al, inf = ts.rx_tx(tseq,
                                        torch.from_numpy(arena.payload[b]),
                                        torch.from_numpy(arena.length[b]))
        assert torch.equal(q, touts["tx_payload"][b])
        assert torch.equal(ql, touts["tx_len"][b])
        assert torch.equal(inf["lm"], touts["info"]["lm"][b])
    fs = convert.flatten(convert.state_to_numpy(tseq))
    for k in ft:
        np.testing.assert_array_equal(fs[k], ft[k], err_msg=k)


def test_batch_without_lm_requests_leaves_the_cache_unchanged(models):
    """The reference skips the model with ``lax.cond`` on such a batch; the
    port runs the step and keeps none of its cache writes."""
    _, tcfg, _, tp = models
    te = TEngine(tcfg, tp, max_sessions=2, max_seq=16)
    smap = {42: te.new_session(np.asarray([1, 2, 3], np.int32))}
    tile = t_lm.make_tile(tcfg, tp, max_sessions=2, max_seq=16)
    ts = t_stack.UdpStack([tile], IP_S, device="cpu",
                          topo=t_stack.rpc_serve_topology(
                              [("lm", "lm_serve", jrpc.MSG_LM_GENERATE)]))
    state = ts.init_state()
    state["apps"]["lm"] = t_lm.adopt_engine(state["apps"]["lm"], te, smap)
    before = convert.flatten(convert.state_to_numpy(state["apps"]["lm"]))
    p, l = F.to_batch([lm_frame(777, 0), lm_frame(42, 1, cut=3)], W)
    state, *_ = ts.rx_tx(state, torch.from_numpy(p), torch.from_numpy(l))
    after = convert.flatten(convert.state_to_numpy(state["apps"]["lm"]))
    for k in before:
        np.testing.assert_array_equal(after[k], before[k], err_msg=k)
    # and the engine's own cache never sees the tile's writes
    p, l = F.to_batch([lm_frame(42, 2)], W)
    state, *_ = ts.rx_tx(state, torch.from_numpy(p), torch.from_numpy(l))
    assert int(state["apps"]["lm"]["pos"][smap[42]]) == 4
    assert int(te.pos[smap[42]]) == 3
    np.testing.assert_array_equal(
        convert.state_to_numpy(te.cache)["units"]["p0"]["k"],
        before["cache/units/p0/k"])


def test_tokens_above_u16_travel_as_their_low_16_bits():
    """qwen1.5's vocabulary (151,936) does not fit the wire's u16 token
    field.  The tile writes a token's low 16 bits (as the reference's tile
    does) and keeps the whole id in its state; the host path's
    ``encode_reply`` masks the same way where the reference's raises."""
    assert t_lm.decode_reply(t_lm.encode_reply(7, [70000, 5])) == \
        (7, [70000 & 0xFFFF, 5], True)
    with pytest.raises(struct.error):
        j_lm.encode_reply(7, [70000])
    from repro_torch.models import model as TM
    cfg = t_serve_config(vocab=1 << 17)
    params = TM.init_params(cfg, seed=1, device="cpu")
    eng = TEngine(cfg, params, max_sessions=2, max_seq=16)
    ref = TEngine(cfg, params, max_sessions=2, max_seq=16)
    prompt = np.asarray([1, 2, 3], np.int32)
    smap = {42: eng.new_session(prompt)}
    ref.new_session(prompt)
    tile = t_lm.make_tile(cfg, params, max_sessions=2, max_seq=16)
    ts = t_stack.UdpStack([tile], IP_S, device="cpu",
                          topo=t_stack.rpc_serve_topology(
                              [("lm", "lm_serve", jrpc.MSG_LM_GENERATE)]))
    state = ts.init_state()
    state["apps"]["lm"] = t_lm.adopt_engine(state["apps"]["lm"], eng, smap)
    wide = 0
    for i in range(6):
        p, l = F.to_batch([lm_frame(42, i)], W)
        state, q, ql, _, _ = ts.rx_tx(state, torch.from_numpy(p),
                                      torch.from_numpy(l))
        full = int(state["apps"]["lm"]["last_tok"][smap[42]])
        assert full == int(ref.step()[smap[42]])
        _, toks, ok = t_lm.decode_reply(reply_body(q[0].numpy(),
                                                   int(ql[0])))
        assert ok and toks == [full & 0xFFFF]
        wide += full > 0xFFFF
    assert wide > 0
