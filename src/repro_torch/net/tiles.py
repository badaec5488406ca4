"""Registered tile functions for the Figure-4 UDP/RPC path.

Importing this module populates the :mod:`repro_torch.core.compiler`
registry: each tile *kind* that can appear in a TopologyConfig maps to one
function here.  The compiler wires them together from the declared routes
— none of these functions knows what comes before or after it in the
chain (the paper's tile-independence property).

Carrier keys (RX direction): ``payload``/``length`` (current packet view),
``meta`` (accumulated header fields), ``alive`` (RX-chain conjunction,
maintained by the executor), ``body``/``blen`` (RPC body for apps),
``out_body``/``out_blen`` (app-modified reply body).  TX direction:
``tx_payload``/``tx_len``/``tx_meta`` and ``tx_csum_offset``.

Ported here: eth/ip/udp RX and TX and the ``rs_serve`` app tile.  The TCP,
NAT, IP-in-IP, management, observability and ``lm_serve`` tiles are not
ported yet (ROADMAP queue 1); a topology naming one fails to compile.
"""
from __future__ import annotations

import torch

from repro_torch.core.compiler import register_tile
from repro_torch.net import eth, ipv4, rpc, udp
from repro_torch.obs import reasons
from repro_torch.transport import rate as rate_mod

# ---------------------------------------------------------------------------
# RX protocol tiles


@register_tile("eth_rx", alive=True, rewrites=("ethertype",))
def eth_rx(state, carrier, pred, ctx):
    p, l, m = eth.parse(carrier["payload"], carrier["length"])
    carrier.update(payload=p, length=l, meta=m)
    return state, carrier, None


@register_tile("ip_rx", alive=True, rewrites=("ip_proto",))
def ip_rx(state, carrier, pred, ctx):
    p, l, m2, ok, reason = ipv4.parse_ex(carrier["payload"],
                                         carrier["length"])
    m = dict(carrier["meta"])
    m.update(m2)
    carrier.update(payload=p, length=l, meta=m, drop_reason=reason)
    return state, carrier, ok


def _udp_init(ctx):
    # dispatch-side token buckets; empty table = unlimited
    return {"rate": rate_mod.init()}


@register_tile("udp_rx", init=_udp_init, alive=True)
def udp_rx(state, carrier, pred, ctx):
    """UDP parse + RPC deframing (apps receive framed request bodies, not
    raw datagrams).  Dispatch applies the per-port token buckets here:
    packets beyond a rate-limited port's bucket drop like a parse
    failure."""
    p, l, m, ok_udp, r_udp = udp.parse_ex(carrier["payload"],
                                          carrier["length"],
                                          carrier["meta"])
    body, blen, rmeta, ok_rpc, r_rpc = rpc.parse_ex(p, l)
    m = dict(m)
    m.update(rmeta)
    carrier.update(payload=p, length=l, meta=m, body=body, blen=blen,
                   out_body=body, out_blen=blen)
    ok = ok_udp & ok_rpc
    # first failing layer attributes the drop: udp, then rpc, then rate
    reason = torch.where(~ok_udp, r_udp, torch.where(~ok_rpc, r_rpc, 0))
    if "rate" in state:
        rt, ok_rate = rate_mod.apply(state["rate"], m["dst_port"],
                                     pred & ok)
        state = dict(state)
        state["rate"] = rt
        reason = torch.where(ok & ~ok_rate, reasons.RATE_LIMIT, reason)
        ok = ok & ok_rate
    carrier["drop_reason"] = reason.to(torch.int32)
    return state, carrier, ok


# ---------------------------------------------------------------------------
# TX protocol tiles


@register_tile("udp_tx")
def udp_tx(state, carrier, pred, ctx):
    """RPC re-framing + UDP build with reply-swapped addressing."""
    m = carrier["meta"]
    q, ql = rpc.build(carrier["out_body"], carrier["out_blen"],
                      m["msg_type"], m["req_id"])
    mtx = dict(m)
    mtx["src_ip"], mtx["dst_ip"] = m["dst_ip"], m["src_ip"]
    mtx["src_port"], mtx["dst_port"] = m["dst_port"], m["src_port"]
    mtx["ip_proto"] = torch.full_like(m["src_ip"], ipv4.PROTO_UDP)
    q, ql = udp.build(q, ql, mtx)
    carrier.update(tx_payload=q, tx_len=ql, tx_meta=mtx, tx_csum_offset=6)
    return state, carrier, None


@register_tile("ip_tx")
def ip_tx(state, carrier, pred, ctx):
    q, ql = ipv4.build(carrier["tx_payload"], carrier["tx_len"],
                       carrier["tx_meta"])
    carrier.update(tx_payload=q, tx_len=ql)
    return state, carrier, None


@register_tile("eth_tx")
def eth_tx(state, carrier, pred, ctx):
    m = carrier["meta"]
    mtx = dict(carrier["tx_meta"])
    mtx["eth_dst_hi"], mtx["eth_dst_lo"] = m["eth_src_hi"], m["eth_src_lo"]
    mtx["eth_src_hi"], mtx["eth_src_lo"] = m["eth_dst_hi"], m["eth_dst_lo"]
    q, ql = eth.build(carrier["tx_payload"], carrier["tx_len"], mtx)
    carrier.update(tx_payload=q, tx_len=ql)
    return state, carrier, None


# ---------------------------------------------------------------------------
# application tiles (direct-attached accelerator compute, paper §5/§6)


def _rs_serve_init(ctx):
    return {"apps": {ctx.name: {
        "ops": torch.zeros((), dtype=torch.int32),
        "bytes": torch.zeros((), dtype=torch.int32)}}}


@register_tile("rs_serve", init=_rs_serve_init)
def rs_serve(state, carrier, pred, ctx):
    """Direct-attached RS(8,2) encode keyed on MSG_RS_ENCODE: 4 KiB data
    in, 1 KiB parity out, computed on the device by the RS kernel.  The
    kernel runs once per batch whatever the batch holds: the reference's
    ``lax.cond`` on ``valid.any()`` is a mask here, never a host branch,
    and rows that are not served keep their reply.  The reference's
    ``use_pallas`` tile parameter has no counterpart: the device decides
    between the kernel and its plain version.  On an arena too narrow for
    a 4 KiB body the tile serves nothing (requests get ERR via blen 0)."""
    from repro_torch.apps import reed_solomon as RS
    from repro_torch.kernels.rs_encode import ops as rs_ops
    body, blen = carrier["body"], carrier["blen"]
    n = body.shape[0]
    info = dict(carrier["info"])
    if body.shape[1] < RS.REQ:                 # arena too narrow: no-serve
        info[ctx.name] = torch.zeros((n,), dtype=torch.bool,
                                     device=body.device)
        carrier["info"] = info
        carrier["out_blen"] = torch.where(pred, 0, carrier["out_blen"])
        carrier["drop_reason"] = torch.where(
            pred, reasons.APP_BAD_REQ, 0).to(torch.int32)
        return state, carrier, None
    valid = pred & (blen >= RS.REQ)
    carrier["drop_reason"] = torch.where(
        pred & ~valid, reasons.APP_BAD_REQ, 0).to(torch.int32)

    parity = rs_ops.encode_blocks(body[:, :RS.REQ], k=RS.K, p=RS.P)
    out = torch.zeros_like(body)
    out[:, :RS.RESP] = parity
    carrier["out_body"] = torch.where(valid[:, None], out,
                                      carrier["out_body"])
    carrier["out_blen"] = torch.where(
        valid, RS.RESP, torch.where(pred, 0, carrier["out_blen"])
    ).to(torch.int32)
    apps = dict(state["apps"])
    a = dict(apps[ctx.name])
    a["ops"] = a["ops"] + valid.sum(dtype=torch.int32)
    a["bytes"] = a["bytes"] + torch.where(valid, RS.REQ, 0).sum(
        dtype=torch.int32)
    apps[ctx.name] = a
    state = dict(state)
    state["apps"] = apps
    info[ctx.name] = valid
    carrier["info"] = info
    return state, carrier, None
