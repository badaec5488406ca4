"""Drop-reason registry: the answer to "which tile dropped this frame and
why".

Every tile that can reject a packet attributes the rejection to one of
these codes by writing it into ``carrier["drop_reason"]`` for the rows it
failed (the executor zeroes the field before each stage, so a code always
names the stage that set it).  The executor folds the codes into a
per-tile ``(reason -> count)`` table — ``telemetry["drops"]``, shape
``(num_nodes, NUM_REASONS)`` — with one fused add per batch, and the
management plane serves rows of it over ``DROP_READ``.

Two kinds of attribution share the table:

  * **hard drops** — the tile returned ``ok=False`` for the row, so the
    packet leaves the pipeline.  A hard drop with no specific code is
    counted under :data:`UNSPEC` (so drops can never disappear from the
    table, only lack detail).
  * **soft drops** — the tile answered the request with an error instead
    of dropping the frame (e.g. ``lm_serve``'s ERR_* sentinel replies).
    The frame stays alive but the rejection is still attributed.

Codes are stable wire values (DROP_READ responses carry counts by index);
append new codes, never renumber.
"""
from __future__ import annotations

NONE = 0               # not dropped
UNSPEC = 1             # dropped with no tile-specific attribution

# ip_rx (ipv4.parse)
IP_VERSION = 2         # version != 4
IP_CSUM = 3            # header checksum mismatch
IP_TTL = 4             # ttl == 0
IP_LEN = 5             # total_len exceeds the received bytes

# udp_rx (udp.parse + rpc.parse + dispatch rate limiting)
RUNT_UDP = 6           # udp_len < 8: header shorter than itself
UDP_LEN = 7            # udp_len exceeds the ip payload
UDP_CSUM = 8           # checksum present and wrong
RPC_MAGIC = 9          # rpc frame magic mismatch
RPC_LEN = 10           # rpc payload_len exceeds the datagram
RATE_LIMIT = 11        # per-port token bucket exhausted

# tcp_rx
TCP_NO_CONN = 12       # no connection-table match and not a SYN

# app tiles (soft drops: error replies, request not served)
APP_BAD_REQ = 13       # malformed / truncated / too-narrow request
APP_NO_SESSION = 14    # unknown session id
APP_NO_SLOT = 15       # session table full / session out of room

# ipinip_decap
IPIP_BAD = 16          # outer header not a decapsulatable IP-in-IP frame

NUM_REASONS = 24       # fixed table width (wire format; room to grow)

NAMES = {
    NONE: "none", UNSPEC: "unspec",
    IP_VERSION: "ip_version", IP_CSUM: "ip_csum", IP_TTL: "ip_ttl",
    IP_LEN: "ip_len",
    RUNT_UDP: "runt_udp", UDP_LEN: "udp_len", UDP_CSUM: "udp_csum",
    RPC_MAGIC: "rpc_magic", RPC_LEN: "rpc_len", RATE_LIMIT: "rate_limit",
    TCP_NO_CONN: "tcp_no_conn",
    APP_BAD_REQ: "app_bad_req", APP_NO_SESSION: "app_no_session",
    APP_NO_SLOT: "app_no_slot",
    IPIP_BAD: "ipip_bad",
}


def name(code: int) -> str:
    return NAMES.get(code, f"reason_{code}")
