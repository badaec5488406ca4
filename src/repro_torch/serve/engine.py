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
        the next install)."""
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
        entry last (-> pad left).  The rest of the slot is zeroed."""
        def put(slot, new, left: bool):
            # slot: (..., T_max, KV, hd) with the sequence axis at -3
            T, W = new.shape[-3], slot.shape[-3]
            if T > W:
                raise ValueError(f"prefill cache of {T} rows does not fit "
                                 f"a slot of {W}")
            slot.zero_()
            if left:
                slot[..., W - T:, :, :] = new
            else:
                slot[..., :T, :, :] = new

        for i, entry in enumerate(self.cfg.pattern):
            mixer, _ = self.cfg.entry(entry)
            for name, leaf in self.cache["units"][f"p{i}"].items():
                new = pcache["units"][f"p{i}"][name][:, 0]   # (U, T, ...)
                put(leaf[:, sid], new, left=(mixer == "attn_l"))
        for j, entry in enumerate(self.cfg.remainder):
            mixer, _ = self.cfg.entry(entry)
            for name, leaf in self.cache["rem"][j].items():
                put(leaf[sid], pcache["rem"][j][name][0],
                    left=(mixer == "attn_l"))

    # ---- batched decode ---------------------------------------------------
    def step(self) -> np.ndarray:
        """One decode step for every active session. Returns next tokens."""
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
