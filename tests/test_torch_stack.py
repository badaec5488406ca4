"""The port's executor against the reference, bit for bit: flow hashing,
dispatch, token buckets, telemetry rows, compile and prune results,
deadlock reports, and whole stacks — ``UdpStack.rx_tx`` and
``run_stream`` (``with_obs=False``, telemetry on) for echo, the
replicated RS app group and the ``rs_serve`` RPC stack, the last also
with the reference's Pallas kernel (``use_pallas``).  Outputs and the whole
state (route tables, buckets, dispatch, app counters, node log, drop
table) are compared after every run; both packages start from one state
carried across with ``repro_torch.convert``.
"""
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.apps import echo as j_echo, reed_solomon as j_rs
from repro.core import deadlock as j_deadlock, routing as j_routing
from repro.core import scaleout as j_scaleout, telemetry as j_telemetry
from repro.core.compiler import StackCompiler as JCompiler
from repro.core.topology import TopologyConfig as JTopo
from repro.net import frames as F, rpc as jrpc
from repro.net import stack as j_stack
from repro.transport import rate as j_rate
from repro_torch import convert
from repro_torch.apps import echo as t_echo, reed_solomon as t_rs
from repro_torch.core import deadlock as t_deadlock, routing as t_routing
from repro_torch.core import scaleout as t_scaleout, telemetry as t_telemetry
from repro_torch.core.compiler import CompileError
from repro_torch.core.compiler import StackCompiler as TCompiler
from repro_torch.core.topology import TopologyConfig as TTopo
from repro_torch.net import stack as t_stack
from repro_torch.transport import rate as t_rate

IP_C, IP_S = F.ip("10.0.0.2"), F.ip("10.0.0.1")


def _np(x):
    a = np.asarray(x)
    return a.astype(np.int64) if a.dtype == np.uint32 else a


def assert_same_tree(j, t, what="state"):
    """Reference tree (jax arrays) == port tree (tensors): same paths,
    dtypes (uint32 as int64) and values."""
    fj = {k: _np(v) for k, v in convert.flatten(jax.device_get(j)).items()}
    ft = convert.flatten(convert.state_to_numpy(t))
    assert fj.keys() == ft.keys(), (what, fj.keys() ^ ft.keys())
    for k in fj:
        assert fj[k].dtype == ft[k].dtype, (what, k, fj[k].dtype,
                                            ft[k].dtype)
        np.testing.assert_array_equal(fj[k], ft[k], err_msg=f"{what}: {k}")


def to_port(topo: JTopo) -> TTopo:
    return TTopo.from_dict(topo.to_dict())


# ---------------------------------------------------------------------------
# routing, dispatch, rate, telemetry


def test_flow_hash_fnv1a_and_route_lookup():
    rng = np.random.default_rng(1)
    n = 256
    meta = {k: rng.integers(0, 2 ** 32 if "ip" in k else 2 ** 16, n,
                            dtype=np.uint64)
            for k in ("src_ip", "dst_ip", "src_port", "dst_port")}
    meta["src_ip"][:4] = [0, 2 ** 32 - 1, 1, 2 ** 31]
    jm = {k: jnp.asarray(v.astype(np.uint32)) for k, v in meta.items()}
    tm = {k: torch.from_numpy(v.astype(np.int64)) for k, v in meta.items()}
    np.testing.assert_array_equal(_np(j_routing.flow_hash(jm)),
                                  t_routing.flow_hash(tm).numpy())
    np.testing.assert_array_equal(
        _np(j_routing.fnv1a([jm["src_ip"], jm["dst_port"]])),
        t_routing.fnv1a([tm["src_ip"], tm["dst_port"]]).numpy())
    entries = [(0x0800, 1), (17, 2), (None, 5), (9400, 3)]
    jt, tt = j_routing.make_table(entries), t_routing.make_table(entries)
    assert_same_tree(jt, tt, "make_table")
    field = rng.integers(-2, 0x0900, n).astype(np.int32)
    field[:3] = [0x0800, 17, 9400]
    np.testing.assert_array_equal(np.asarray(jt.lookup(jnp.asarray(field))),
                                  tt.lookup(torch.from_numpy(field)).numpy())
    assert_same_tree(jt.set_entry(4, 6, 7), tt.set_entry(4, 6, 7),
                     "set_entry")


@pytest.mark.parametrize("policy", ["round_robin", "flow_hash",
                                    "port_match"])
def test_dispatch_lane_with_drained_replicas(policy):
    rng = np.random.default_rng(2)
    jd = j_scaleout.make_dispatch([0, 1, 2, 3, 4])
    jd = j_scaleout.mark_health(jd, 1, False)
    td = convert.state_from_numpy(jax.device_get(jd))
    assert_same_tree(jd, t_scaleout.mark_health(
        t_scaleout.make_dispatch([0, 1, 2, 3, 4]), 1, False), "dispatch")
    for step in range(3):
        n = 32
        meta = {"src_ip": rng.integers(0, 2 ** 32, n, dtype=np.uint64),
                "dst_ip": rng.integers(0, 2 ** 32, n, dtype=np.uint64),
                "src_port": rng.integers(0, 2 ** 16, n, dtype=np.uint64),
                "dst_port": rng.integers(9000, 9010, n, dtype=np.uint64)}
        meta["dst_port"][0] = 8990                  # below the base port
        pred = rng.integers(0, 2, n).astype(bool)
        jd, jl = j_scaleout.dispatch_lane(
            jd, policy, {k: jnp.asarray(v.astype(np.uint32))
                         for k, v in meta.items()},
            jnp.asarray(pred), base_port=9000)
        td, tl = t_scaleout.dispatch_lane(
            td, policy, {k: torch.from_numpy(v.astype(np.int64))
                         for k, v in meta.items()},
            torch.from_numpy(pred), base_port=9000)
        np.testing.assert_array_equal(np.asarray(jl), tl.numpy())
        assert_same_tree(jd, td, f"dispatch step {step}")
        if step == 1:
            jd = j_scaleout.mark_health(jd, 3, False)
            td = t_scaleout.mark_health(td, 3, False)


def test_rate_buckets_over_several_batches():
    rng = np.random.default_rng(3)
    jr, tr = j_rate.init(), t_rate.init()
    for slot, port, rate, burst in ((0, 9000, 2, 5), (3, 9001, 1, None)):
        jr = j_rate.set_slot(jr, slot, port, rate, burst)
        tr = t_rate.set_slot(tr, slot, port, rate, burst)
    jr, tr = j_rate.clear_slot(jr, 3), t_rate.clear_slot(tr, 3)
    jr = j_rate.set_slot(jr, 5, 9002, 1)
    tr = t_rate.set_slot(tr, 5, 9002, 1)
    assert_same_tree(jr, tr, "set_slot")
    for step in range(4):
        port = rng.integers(8999, 9004, 24).astype(np.uint32)
        arrived = rng.integers(0, 4, 24) > 0
        jr, jok = j_rate.apply(jr, jnp.asarray(port), jnp.asarray(arrived))
        tr, tok = t_rate.apply(tr, torch.from_numpy(port.astype(np.int64)),
                               torch.from_numpy(arrived))
        np.testing.assert_array_equal(np.asarray(jok), tok.numpy())
        assert_same_tree(jr, tr, f"rate step {step}")


def test_telemetry_rows_ring_and_drop_counts():
    rng = np.random.default_rng(4)
    nodes = 5
    jl, tl = j_telemetry.make_node_log(nodes), t_telemetry.make_node_log(nodes)
    assert_same_tree(jl, tl, "make_node_log")
    lat = rng.integers(0, 50, nodes).astype(np.int32)
    for step in range(70):                          # wraps the 64-deep ring
        pk = rng.integers(0, 99, nodes).astype(np.int32)
        dr = rng.integers(0, 9, nodes).astype(np.int32)
        jrow = j_telemetry.counter_rows(
            jnp.int32(step), jnp.asarray(pk), jnp.asarray(dr),
            jnp.asarray(lat), jnp.arange(nodes, dtype=jnp.int32))
        trow = t_telemetry.counter_rows(
            torch.tensor(step, dtype=torch.int32), torch.from_numpy(pk),
            torch.from_numpy(dr), torch.from_numpy(lat),
            torch.arange(nodes, dtype=torch.int32))
        np.testing.assert_array_equal(np.asarray(jrow), trow.numpy())
        jl = j_telemetry.append_stacked(jl, jrow)
        tl = t_telemetry.append_stacked(tl, trow)
    assert_same_tree(jl, tl, "append_stacked")
    for i in range(nodes):
        jv, tv = j_telemetry.node_view(jl, i), t_telemetry.node_view(tl, i)
        assert_same_tree(jv, tv, "node_view")
        np.testing.assert_array_equal(np.asarray(j_telemetry.latest(jv, 3)),
                                      t_telemetry.latest(tv, 3).numpy())
    reason = rng.integers(0, 24, 40).astype(np.int32)
    counted = rng.integers(0, 2, 40).astype(bool)
    np.testing.assert_array_equal(
        np.asarray(j_telemetry.reason_counts(jnp.asarray(reason),
                                             jnp.asarray(counted), 24)),
        t_telemetry.reason_counts(torch.from_numpy(reason),
                                  torch.from_numpy(counted), 24).numpy())


# ---------------------------------------------------------------------------
# compile, prune, deadlock


def _pruned_topology(pkg_topo):
    """The RPC stack plus a stage behind ip_rx keyed on an ethertype that
    eth_rx's route already fixed: statically dead, pruned."""
    topo = pkg_topo([("rs", "rs_serve", 2)])
    topo.dim_x += 1
    topo.add_tile("udp_rx6", "udp_rx", 4, 0)
    topo.add_route("ip_rx", "ethertype", 0x86DD, "udp_rx6")
    topo.add_route("udp_rx6", "const", None, "udp_tx")
    return topo


def _topologies():
    return {
        "echo": (j_stack.udp_topology([j_echo.make(port=7)]),
                 t_stack.udp_topology([t_echo.make(port=7)]),
                 ([j_echo.make(port=7)], [t_echo.make(port=7)])),
        "rs_group": (j_stack.udp_topology([j_rs.make(n_replicas=4),
                                           j_echo.make(port=7)]),
                     t_stack.udp_topology([t_rs.make(n_replicas=4),
                                           t_echo.make(port=7)]),
                     ([j_rs.make(n_replicas=4), j_echo.make(port=7)],
                      [t_rs.make(n_replicas=4), t_echo.make(port=7)])),
        "rs_serve": (j_stack.rpc_serve_topology([("rs", "rs_serve", 2)]),
                     t_stack.rpc_serve_topology([("rs", "rs_serve", 2)]),
                     ([], [])),
        "pruned": (_pruned_topology(j_stack.rpc_serve_topology),
                   _pruned_topology(t_stack.rpc_serve_topology), ([], [])),
    }


@pytest.mark.parametrize("name", ["echo", "rs_group", "rs_serve", "pruned"])
def test_compile_and_prune_match_reference(name):
    jtopo, ttopo, (japps, tapps) = _topologies()[name]
    assert jtopo.to_dict() == ttopo.to_dict()
    assert jtopo.validate() == ttopo.validate() == []
    jp = JCompiler(jtopo, bindings={a.name: a for a in japps}).compile(
        "eth_rx")
    tp = TCompiler(ttopo, bindings={a.name: a for a in tapps}).compile(
        "eth_rx")
    assert jp.order == tp.order
    assert jp.pruned == tp.pruned
    assert (name == "pruned") == ("udp_rx6" in tp.pruned)
    assert jp.table_entries == tp.table_entries
    assert jp.summary() == tp.summary()
    assert jp.pipe_meta == tp.pipe_meta
    assert [s[4] for s in jp.stages] == [s[4] for s in tp.stages]   # trunk
    assert [s[2].lat_cycles for s in jp.stages] == \
        [s[2].lat_cycles for s in tp.stages]


def _fig5(pkg_topo, layout):
    topo = pkg_topo("fig5", 4, 1)
    for nm, (x, y) in layout.items():
        topo.add_tile(nm, nm, x, y)
    topo.add_chain("eth_rx", "ip_rx", "udp_rx", "app")
    return topo


@pytest.mark.parametrize("layout", [
    {"eth_rx": (0, 0), "udp_rx": (1, 0), "ip_rx": (2, 0), "app": (3, 0)},
    {"eth_rx": (0, 0), "ip_rx": (1, 0), "udp_rx": (2, 0), "app": (3, 0)},
    "ring", "rs_group"])
def test_deadlock_reports_match_reference(layout):
    if layout == "ring":
        def build(pkg_topo):
            topo = pkg_topo("cross", 2, 2)
            for nm, x, y in (("a", 0, 0), ("b", 1, 0), ("c", 1, 1),
                             ("d", 0, 1)):
                topo.add_tile(nm, nm, x, y)
            topo.add_chain("a", "b", "c")
            topo.add_chain("c", "d", "a")
            topo.add_chain("b", "c", "d", "a", "b")
            return topo
        jtopo, ttopo = build(JTopo), build(TTopo)
    elif layout == "rs_group":
        jtopo, ttopo, _ = _topologies()["rs_group"]
    else:
        jtopo, ttopo = _fig5(JTopo, layout), _fig5(TTopo, layout)
    jr, tr = j_deadlock.analyze(jtopo), t_deadlock.analyze(ttopo)
    assert jr.ok == tr.ok
    assert repr(jr.self_conflicts) == repr(tr.self_conflicts)
    assert repr(jr.cycles) == repr(tr.cycles)
    assert jr.summary() == tr.summary()


def test_slice_refusals_name_their_roadmap_items():
    """Not-yet-ported parts are refused, never run wrong."""
    stack = t_stack.UdpStack([t_echo.make()], IP_S, device="cpu",
                             with_obs=True)
    with pytest.raises(NotImplementedError, match="observability"):
        stack.init_state()
    with pytest.raises(CompileError, match="management"):
        t_stack.UdpStack([t_echo.make()], IP_S, mgmt_port=9909,
                         device="cpu")
    rss = to_port(j_stack.replicated_udp_topology([j_echo.make()]))
    with pytest.raises(CompileError, match="replica groups"):
        t_stack.UdpStack([t_echo.make()], IP_S, topo=rss, device="cpu")
    nat = to_port(j_stack.udp_topology_with_nat([j_echo.make()]))
    with pytest.raises(CompileError, match="nat_rx"):
        t_stack.UdpStack([t_echo.make()], IP_S, topo=nat, device="cpu")


# ---------------------------------------------------------------------------
# whole stacks: rx_tx and run_stream


def _rpc(sport, dport, msg, rid, body):
    return F.udp_rpc_frame(IP_C, IP_S, sport, dport,
                           jrpc.np_frame(msg, rid, body))


def _bad_frames(dport, msg):
    bad_ip = bytearray(_rpc(5000, dport, msg, 90, b"x" * 8))
    bad_ip[20] ^= 0xFF
    runt = F.eth_frame(b"\x02\x00\x00\x00\x00\x01",
                       b"\x02\x00\x00\x00\x00\x02", 0x0800,
                       F.ipv4_packet(IP_C, IP_S, 17, struct.pack(
                           "!HHHH", 5000, dport, 5, 0)
                           + jrpc.np_frame(msg, 91, b"r")))
    magic = F.udp_rpc_frame(IP_C, IP_S, 5000, dport, b"\x00\x00" + bytes(20))
    arp = F.eth_frame(b"\xff" * 6, b"\x02" * 6, 0x0806, bytes(28))
    return [bytes(bad_ip), runt, magic, arp, b""]


def _batches(case, rng, n_batches, B=8):
    frames = []
    for b in range(n_batches):
        for i in range(B - 5 if b == 0 else B):
            rid = b * B + i
            if case == "echo":
                fr = _rpc(5000 + i, 7 if i % 4 else 8, 1, rid,
                          rng.integers(0, 256, int(rng.integers(0, 60)),
                                       dtype=np.uint8).tobytes())
            elif case == "rs_group":
                body = rng.integers(0, 256, 4096 if i % 3 else 100,
                                    dtype=np.uint8).tobytes()
                fr = _rpc(5000 + i, 9000 if i % 5 else 7, 1, rid, body)
            else:
                msg = 2 if i % 4 else 1
                body = rng.integers(0, 256, 4096 if i % 3 else 50,
                                    dtype=np.uint8).tobytes()
                fr = _rpc(5000 + i, 9400, msg, rid, body)
            frames.append(fr)
        if b == 0:
            frames += _bad_frames(7 if case == "echo" else 9000 if
                                  case == "rs_group" else 9400,
                                  1 if case != "rs_serve" else 2)
    width = 128 if case == "echo" else 4160
    arena = F.FrameArena(n_batches, B, width)
    arena.fill(frames)
    return arena.payload, arena.length


def _stacks(case):
    if case == "echo":
        ja, ta = [j_echo.make(port=7, n_replicas=2)], \
            [t_echo.make(port=7, n_replicas=2)]
        return (j_stack.UdpStack(ja, IP_S, with_obs=False),
                t_stack.UdpStack(ta, IP_S, device="cpu"))
    if case == "rs_group":
        ja, ta = [j_rs.make(n_replicas=4), j_echo.make(port=7)], \
            [t_rs.make(n_replicas=4), t_echo.make(port=7)]
        return (j_stack.UdpStack(ja, IP_S, with_obs=False),
                t_stack.UdpStack(ta, IP_S, device="cpu"))
    params = {"rs": {"use_pallas": True}} if case == "rs_serve_pallas" \
        else None
    jt = j_stack.rpc_serve_topology([("rs", "rs_serve", 2)], params=params)
    tt = t_stack.rpc_serve_topology([("rs", "rs_serve", 2)], params=params)
    return (j_stack.UdpStack([], IP_S, topo=jt, with_obs=False),
            t_stack.UdpStack([], IP_S, topo=tt, device="cpu"))


@pytest.mark.parametrize("case", ["echo", "rs_group", "rs_serve",
                                  "rs_serve_pallas"])
def test_stack_rx_tx_and_stream_match_reference(case):
    rng = np.random.default_rng(11)
    n_batches = 3
    payload, length = _batches(case.replace("_pallas", ""), rng, n_batches)
    js, ts = _stacks(case)

    jstate = js.init_state()
    tstate = convert.state_from_numpy(jax.device_get(jstate))
    assert_same_tree(jstate, ts.init_state(), "init_state")
    assert_same_tree(jstate, tstate, "state_from_numpy")

    # one batch
    jout = jax.jit(js.rx_tx)(jstate, jnp.asarray(payload[0]),
                             jnp.asarray(length[0]))
    tout = ts.rx_tx(tstate, torch.from_numpy(payload[0]),
                    torch.from_numpy(length[0]))
    for name, j, t in zip(("state", "tx_payload", "tx_len", "alive",
                           "info"), jout, tout):
        assert_same_tree(j, t, f"rx_tx {name}")

    # the stream, from the state the single batch left
    jst, jouts = jax.jit(js.run_stream)(jout[0], jnp.asarray(payload),
                                        jnp.asarray(length))
    tst, touts = ts.stream_fn()(tout[0], torch.from_numpy(payload),
                                torch.from_numpy(length))
    assert_same_tree(jouts, touts, "run_stream outs")
    assert_same_tree(jst, tst, "run_stream state")

    # the port's stream equals its own sequential rx_tx calls
    st = tout[0]
    for b in range(n_batches):
        st, q, ql, alive, info = ts.rx_tx(st, torch.from_numpy(payload[b]),
                                          torch.from_numpy(length[b]))
        assert torch.equal(q, touts["tx_payload"][b])
        assert torch.equal(ql, touts["tx_len"][b])
        assert torch.equal(alive, touts["alive"][b])
    assert_same_tree(convert.state_to_numpy(st), tst, "stream vs sequential")

    # something was dropped and something was served
    drops = np.asarray(jst["telemetry"]["drops"])
    assert drops.sum() > 0
    assert np.asarray(jouts["alive"]).sum() > 0
