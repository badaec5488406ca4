"""LM serving engine: session-slot KV-cache management, batched decode,
and live session migration — the reference's ``repro.serve.engine``.

Each engine is an "application tile" behind the network stack; sessions
are flows, and ``migrate_out`` / ``migrate_in`` move a session between
engines as the paper's TCP live migration moves a connection.

Cache layout: stacked (``n_units`` leading axis) with a session axis of
size ``max_sessions``; per-session positions drive the decode writes.  The
engine's cache is updated in place (prefill installs into a slot, every
step writes one row per session and layer); ``migrate_out`` hands out
copies.  The engine lives on the device of its parameters.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from repro_torch.models import model
from repro_torch.models.config import ModelConfig


def _broadcasts(shape, into) -> bool:
    """True when a tensor of ``shape`` broadcasts to exactly ``into``."""
    return len(shape) <= len(into) and all(
        a in (1, b) for a, b in zip(shape[::-1], into[::-1]))


class ServeEngine:
    def __init__(self, cfg: ModelConfig, params: model.Params,
                 max_sessions: int = 4, max_seq: int = 128):
        if not cfg.supports_decode:
            raise ValueError(f"{cfg.name} has no decode step (an encoder)")
        self.cfg = cfg
        self.params = params
        self.device = params.final_norm["scale"].device
        self.M = max_sessions
        self.S = max_seq
        self.cache = model.init_cache(cfg, max_sessions, max_seq,
                                      device=self.device)
        self.pos = torch.zeros((max_sessions,), dtype=torch.int32,
                               device=self.device)
        self.used = np.zeros((max_sessions,), bool)
        self.last_tok = torch.zeros((max_sessions,), dtype=torch.int32,
                                    device=self.device)

    # ---- session lifecycle -----------------------------------------------
    def has_free_slot(self) -> bool:
        return bool((~self.used).any())

    def release(self, sid: int) -> None:
        """Free slot `sid` (explicit close / LRU eviction).  The cache
        column is left in place — a freed slot's stale entries are
        invisible (attention never reads past `pos`, and `pos` is reset on
        the next install; a recurrent state is overwritten whole by the
        next install)."""
        self.used[sid] = False
        self.pos[sid] = 0
        self.last_tok[sid] = 0

    def new_session(self, prompt_tokens: np.ndarray) -> int:
        """Prefill the prompt into a free slot; returns the session id."""
        free = np.where(~self.used)[0]
        if not len(free):
            raise RuntimeError("no free session slots")
        sid = int(free[0])
        tokens = torch.as_tensor(np.asarray(prompt_tokens),
                                 device=self.device)
        logits, pcache = model.prefill(self.cfg, self.params,
                                       {"tokens": tokens[None, :]})
        tok = model.greedy_token(self.cfg, logits)[0]
        P = int(prompt_tokens.shape[0])
        self._install_cache(sid, pcache)
        self.pos[sid] = P
        self.last_tok[sid] = tok
        self.used[sid] = True
        return sid

    def _install_cache(self, sid: int, pcache):
        """Copy a prefill cache (seq length T) into slot `sid`, in place.

        Alignment: global-attention caches are prefix-aligned (position i
        at index i -> pad right); rolling-window caches keep the newest
        entry last (-> pad left); the rest of such a slot is zeroed.
        Recurrent states (Mamba's ``h`` and ``conv``) are copied as they
        are, with the reference's broadcasting: a 1-token prompt's one
        conv row fills all W-1 rows, and a prompt of 2 to W-2 tokens does
        not fit (the reference raises there too).  Every leaf is checked
        before any is written, so a refused install leaves the engine as
        it was."""
        def put(slot, new, left: bool):
            # slot: (..., T_max, KV, hd) with the sequence axis at -3
            T, W = new.shape[-3], slot.shape[-3]
            slot.zero_()
            if left:
                slot[..., W - T:, :, :] = new
            else:
                slot[..., :T, :, :] = new

        moves = []
        for i, entry in enumerate(self.cfg.pattern):
            mixer, _ = self.cfg.entry(entry)
            for name, leaf in self.cache["units"][f"p{i}"].items():
                new = pcache["units"][f"p{i}"][name][:, 0]   # (U, T, ...)
                moves.append((leaf[:, sid], new, mixer, name))
        for j, entry in enumerate(self.cfg.remainder):
            mixer, _ = self.cfg.entry(entry)
            for name, leaf in self.cache["rem"][j].items():
                moves.append((leaf[sid], pcache["rem"][j][name][0], mixer,
                              name))
        for slot, new, mixer, name in moves:
            if name in ("k", "v"):
                if new.shape[-3] > slot.shape[-3]:
                    raise ValueError(f"prefill cache of {new.shape[-3]} rows "
                                     f"does not fit a slot of "
                                     f"{slot.shape[-3]}")
            elif not _broadcasts(new.shape, slot.shape):
                raise ValueError(
                    f"the prefill state {name!r} of shape "
                    f"{tuple(new.shape)} does not broadcast into the slot's "
                    f"{tuple(slot.shape)}: as in the reference's "
                    f"_install_cache, a prompt shorter than the conv state "
                    f"(W-1 = {slot.shape[-2]} rows) installs only when it "
                    f"has 1 token")
        for slot, new, mixer, name in moves:
            if name in ("k", "v"):
                put(slot, new, left=(mixer == "attn_l"))
            else:
                slot.copy_(new.expand_as(slot))

    # ---- batched decode ---------------------------------------------------
    def step(self) -> np.ndarray:
        """One decode step for every active session. Returns next tokens.

        As in the reference, the step runs over every slot: a free slot's
        position and token stay, but its recurrent state (Mamba) moves on
        each step until the next install overwrites it."""
        logits, self.cache = model.decode_step(self.cfg, self.params,
                                               self.cache, self.last_tok,
                                               self.pos)
        nxt = model.greedy_token(self.cfg, logits)
        used = torch.as_tensor(self.used, device=self.device)
        self.pos = self.pos + used.to(torch.int32)
        self.last_tok = torch.where(used, nxt, self.last_tok)
        return self.last_tok.cpu().numpy()

    def generate(self, sid: int, n: int) -> List[int]:
        out = []
        for _ in range(n):
            toks = self.step()
            out.append(int(toks[sid]))
        return out

    # ---- live migration (the paper's §6.7, generalized to sessions) -------
    def migrate_out(self, sid: int) -> Dict:
        """Serialize session `sid` (copies of its cache column, position
        and last token)."""
        blob = {
            "units": {k: {n: t[:, sid].clone() for n, t in c.items()}
                      for k, c in self.cache["units"].items()},
            "rem": [{n: t[sid].clone() for n, t in c.items()}
                    for c in self.cache["rem"]],
            "pos": self.pos[sid].clone(),
            "last_tok": self.last_tok[sid].clone(),
        }
        self.used[sid] = False
        return blob

    def migrate_in(self, blob: Dict) -> int:
        free = np.where(~self.used)[0]
        if not len(free):
            raise RuntimeError("no free session slots")
        sid = int(free[0])
        for k, c in self.cache["units"].items():
            for n, t in c.items():
                t[:, sid] = blob["units"][k][n]
        for j, c in enumerate(self.cache["rem"]):
            for n, t in c.items():
                t[sid] = blob["rem"][j][n]
        self.pos[sid] = blob["pos"]
        self.last_tok[sid] = blob["last_tok"]
        self.used[sid] = True
        return sid
