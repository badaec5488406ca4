"""LM serving application behind the Beehive stack — the reference's
``repro.apps.lm_server``.

Requests arrive as RPC-over-UDP (MSG_LM_GENERATE):
  payload = [session u32 | n_gen u16 | n_prompt u16 | prompt tokens u16...]
Reply:
  payload = [session u32 | n_out u16 | tokens u16 ...]
An error reply carries a sentinel in n_out (>= ERR_BASE) and no tokens.
MSG_LM_RELEASE closes a session explicitly: payload = [session u32].

Two serving paths share this wire format:

  * **host-mediated** (`LmServerApp.handle`): the CPU-attached baseline —
    the host parses the request, drives the `ServeEngine`, and frames the
    reply.  Sessions are LRU-tracked; slot exhaustion evicts (or returns an
    error reply) instead of raising.
  * **direct-attached** (`make_tile` + the `lm_serve` tile in net/tiles.py):
    the paper's headline path — session/KV state lives in the compiled
    stack's state (carried by `run_stream` from batch to batch), and each
    arriving MSG_LM_GENERATE triggers one decode step on the device with
    the reply built in the same batch.  Prompts are prefilled through the
    engine and *adopted* into the tile state (`adopt_engine`); after that
    the ingest -> decode -> reply loop never waits for the host.
"""
from __future__ import annotations

import dataclasses
import struct
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.models import model
from repro_torch.net import bytesops as B
from repro_torch.serve.engine import ServeEngine
from repro_torch.tree import tree_map

REQ_HLEN = 8           # session u32 | n_gen u16 | n_prompt u16
REP_HLEN = 6           # session u32 | n_out u16

# error sentinels carried in the reply's n_out field (a real reply can
# never reach them: tokens are u16, so n_out tops out near payload_len/2)
ERR_BASE = 0xFFF0
ERR_BAD_REQUEST = 0xFFFF   # malformed / truncated request payload
ERR_NO_SLOT = 0xFFFE       # engine full and eviction disabled
ERR_NO_SESSION = 0xFFFD    # unknown session (or no prompt to open one)


def encode_request(session: int, n_gen: int, prompt: List[int]) -> bytes:
    return struct.pack("!IHH", session, n_gen, len(prompt)) + \
        b"".join(struct.pack("!H", t) for t in prompt)


def encode_release(session: int) -> bytes:
    return struct.pack("!I", session)


def decode_request(payload: bytes) -> Tuple[int, int, List[int], bool]:
    """Bounds-checked parse mirroring rpc.parse's ok-flag convention:
    returns (session, n_gen, prompt, ok) and never raises on truncation."""
    if len(payload) < REQ_HLEN:
        return 0, 0, [], False
    session, n_gen, n_prompt = struct.unpack("!IHH", payload[:REQ_HLEN])
    end = REQ_HLEN + 2 * n_prompt
    if end > len(payload):
        return session, n_gen, [], False
    toks = list(struct.unpack(f"!{n_prompt}H", payload[REQ_HLEN:end])) \
        if n_prompt else []
    return session, n_gen, toks, True


def encode_reply(session: int, tokens: List[int]) -> bytes:
    """Tokens travel as u16: a token id above 0xFFFF (qwen1.5's vocabulary
    has 151,936) keeps its low 16 bits, as the device tile writes it.  The
    reference's ``encode_reply`` raises ``struct.error`` there instead."""
    return struct.pack("!IH", session, len(tokens)) + \
        b"".join(struct.pack("!H", t & 0xFFFF) for t in tokens)


def encode_error(session: int, code: int) -> bytes:
    if code < ERR_BASE:
        raise ValueError(f"error code {code:#x} below ERR_BASE")
    return struct.pack("!IH", session, code)


def decode_reply(payload: bytes) -> Tuple[int, List[int], bool]:
    """Returns (session, tokens, ok).  Error replies decode as
    (session, [], True) — use :func:`reply_error` to read the code."""
    if len(payload) < REP_HLEN:
        return 0, [], False
    session, n = struct.unpack("!IH", payload[:REP_HLEN])
    if n >= ERR_BASE:
        return session, [], True
    end = REP_HLEN + 2 * n
    if end > len(payload):
        return session, [], False
    toks = list(struct.unpack(f"!{n}H", payload[REP_HLEN:end])) if n else []
    return session, toks, True


def reply_error(payload: bytes) -> Optional[int]:
    """The error sentinel of a reply, or None for a success reply."""
    if len(payload) < REP_HLEN:
        return None
    _, n = struct.unpack("!IH", payload[:REP_HLEN])
    return n if n >= ERR_BASE else None


class LmServerApp:
    """Host-side application loop around a ServeEngine (the CPU-attached
    baseline).  Sessions are LRU-ordered; when the engine is full a new
    session evicts the least-recently-used one (``evict="lru"``, default)
    or gets an ERR_NO_SLOT reply (``evict=None``).  Malformed requests get
    an error reply — no ingest path raises."""

    def __init__(self, engine: ServeEngine, evict: Optional[str] = "lru"):
        self.engine = engine
        self.evict = evict
        self.session_map: "OrderedDict[int, int]" = OrderedDict()

    def handle(self, payload: bytes) -> bytes:
        session, n_gen, prompt, ok = decode_request(payload)
        if not ok:
            return encode_error(session, ERR_BAD_REQUEST)
        if session not in self.session_map:
            if not prompt:
                # a follow-up for a session we don't hold (evicted, or
                # never opened) — nothing to prefill from
                return encode_error(session, ERR_NO_SESSION)
            if not self.engine.has_free_slot():
                if self.evict == "lru" and self.session_map:
                    victim = next(iter(self.session_map))
                    self.release(victim)
                else:
                    return encode_error(session, ERR_NO_SLOT)
            try:
                sid = self.engine.new_session(np.asarray(prompt, np.int32))
            except RuntimeError:
                return encode_error(session, ERR_NO_SLOT)
            self.session_map[session] = sid
        self.session_map.move_to_end(session)
        sid = self.session_map[session]
        toks = self.engine.generate(sid, n_gen)
        return encode_reply(session, toks)

    def handle_release(self, payload: bytes) -> bytes:
        """MSG_LM_RELEASE: explicit session close."""
        if len(payload) < 4:
            return encode_error(0, ERR_BAD_REQUEST)
        session = struct.unpack("!I", payload[:4])[0]
        if self.release(session):
            return encode_reply(session, [])
        return encode_error(session, ERR_NO_SESSION)

    def release(self, session: int) -> bool:
        sid = self.session_map.pop(session, None)
        if sid is None:
            return False
        self.engine.release(sid)
        return True

    # ---- migration --------------------------------------------------------
    def migrate_session_to(self, session: int, other: "LmServerApp") -> None:
        sid = self.session_map.pop(session)
        blob = self.engine.migrate_out(sid)
        other.session_map[session] = other.engine.migrate_in(blob)


# ---------------------------------------------------------------------------
# direct-attached serving: the device-resident LM tile
#
# The tile's state (cache / pos / last_tok / used / sess_ids) lives in the
# compiled stack's state, so `run_stream` carries it from batch to batch —
# a request arriving in batch i advances its session for batch i+1 with no
# host involvement.  Prompts are prefilled through the ordinary ServeEngine
# and adopted via `adopt_engine`.


@dataclasses.dataclass
class LmTileDecl:
    """Binding for a `lm_serve` tile (passed to the compiler by node name,
    like an AppDecl).  `state` is the template the tile init copies."""
    name: str
    cfg: Any
    params: Any
    max_sessions: int
    max_seq: int
    state: Dict[str, Any]


def make_tile(cfg, params: model.Params, max_sessions: int = 4,
              max_seq: int = 64, name: str = "lm") -> LmTileDecl:
    """The tile's binding, with its template state on the parameters'
    device.  ``sess_ids`` holds the reference's uint32 session ids as
    int64."""
    dev = params.final_norm["scale"].device
    state = {
        "cache": model.init_cache(cfg, max_sessions, max_seq, device=dev),
        "pos": torch.zeros((max_sessions,), dtype=torch.int32, device=dev),
        "last_tok": torch.zeros((max_sessions,), dtype=torch.int32,
                                device=dev),
        "used": torch.zeros((max_sessions,), dtype=torch.bool, device=dev),
        "sess_ids": torch.zeros((max_sessions,), dtype=torch.int64,
                                device=dev),
        "served": torch.zeros((), dtype=torch.int32, device=dev),
    }
    return LmTileDecl(name=name, cfg=cfg, params=params,
                      max_sessions=max_sessions, max_seq=max_seq,
                      state=state)


def adopt_engine(tile_state: Dict[str, Any], engine: ServeEngine,
                 session_map: Dict[int, int]) -> Dict[str, Any]:
    """Install a prefilled engine's sessions into a tile state (e.g.
    ``state["apps"]["lm"]``).  `session_map` maps client session id ->
    engine slot (`LmServerApp.session_map` works as-is).  Tensors are
    copied: the tile updates its cache in place, and that must never reach
    the engine's own."""
    M = engine.M
    ids = np.zeros((M,), np.int64)
    used = np.zeros((M,), bool)
    for sess, slot in session_map.items():
        ids[slot] = int(sess) & 0xFFFFFFFF
        used[slot] = bool(engine.used[slot])
    dev = engine.device
    st = dict(tile_state)
    st.update(
        cache=tree_map(torch.clone, engine.cache),
        pos=engine.pos.clone(),
        last_tok=engine.last_tok.clone(),
        used=torch.from_numpy(used).to(dev),
        sess_ids=torch.from_numpy(ids).to(dev),
    )
    return st


def tile_process(decl: LmTileDecl, st: Dict[str, Any], body, blen, active):
    """One batch through the device LM tile: parse requests, run ONE decode
    step for every session addressed by a valid request, build replies.

    Nothing here waits for the host.  A request generates exactly one
    token (clients stream follow-up requests for more); duplicate requests
    for one session within a batch coalesce into a single step.  Invalid
    rows (short body, unknown session, out-of-room session) get an error
    reply and advance nothing.

    The reference skips the model with ``lax.cond`` on batches that
    advance no session.  Here the step runs on every batch and its cache
    writes are kept only when some session advances — a device-side
    select, never a host branch — so the state equals the reference's.
    The cache is updated in place."""
    cfg, params, S = decl.cfg, decl.params, decl.max_seq

    sess = B.be32(body, 0)                              # (B,) uint32 as int64
    n_gen = B.be16(body, 4)
    ok_len = (blen >= REQ_HLEN) & (n_gen >= 1)
    match = st["used"][None, :] & (st["sess_ids"][None, :] == sess[:, None])
    hit = match.any(dim=1)
    slot = match.to(torch.int32).argmax(dim=1)          # garbage if ~hit
    room = (st["pos"] < S)[slot]
    valid = active & ok_len & hit & room
    adv = (match & valid[:, None]).any(dim=0)           # (M,) sessions to step

    logits, cache = model.decode_step(cfg, params, st["cache"],
                                      st["last_tok"], st["pos"],
                                      write=adv.any())
    nxt = model.greedy_token(cfg, logits)
    new_pos = st["pos"] + adv.to(torch.int32)
    new_last = torch.where(adv, nxt, st["last_tok"])

    tok = new_last[slot].to(torch.int64)                # (B,)
    out = torch.zeros_like(body)
    B.set_be32(out, 0, sess)
    n_out = torch.where(
        valid, 1,
        torch.where(~ok_len, ERR_BAD_REQUEST,
                    torch.where(~hit, ERR_NO_SESSION,
                                ERR_NO_SLOT)))          # session out of room
    B.set_be16(out, 4, n_out)
    B.set_be16(out, 6, torch.where(valid, tok, 0))       # low 16 bits
    out_blen = torch.where(valid, REP_HLEN + 2, REP_HLEN).to(blen.dtype)

    new_st = dict(st)
    new_st.update(cache=cache, pos=new_pos, last_tok=new_last,
                  served=st["served"] + valid.sum(dtype=torch.int32))
    return new_st, out, out_blen
