"""The port's async actor/learner runtime (``repro_torch.runtime``) on
the CPU, against the JAX package's on the cases of its own tests
(tests/test_runtime.py, tests/test_chaos.py).

Pinned properties:
  * async at staleness bound 0 with the full cohort reproduces the
    port's synchronous ``FederatedAveraging`` loop bitwise (one codec,
    one device), and the JAX package's loop within the decode's
    tolerance;
  * transports carry integer payloads exactly (thread and spawned
    process);
  * the round buffer, the staleness weights, the fault plans and the
    monitor's summary decide as the JAX package's do;
  * every fault scenario runs to completion and shows in the
    realized-cohort accounting; a learner crash recovers bitwise from
    its checkpoint.
The fault scenarios' timeouts and delays are the reference tests',
scaled up 2-6x with their ratios kept: the port's codec runs op by op on
the CPU, slower than the reference's compiled one when the test workers
share the machine.  Inputs are made with numpy from a seed."""
import dataclasses
import queue

import numpy as np
import pytest
import torch

from repro.fl import federated as jfl
from repro.runtime import buffer as jbuffer
from repro.runtime import chaos as jchaos
from repro.runtime import monitor as jmonitor
from repro.runtime.workloads import QuadraticWorkload as JQuad
from repro_torch.fl.federated import FederatedAveraging, FLConfig
from repro_torch.runtime import (
    AsyncFederatedRuntime,
    ClientSpec,
    ClientUpdate,
    Fault,
    FaultPlan,
    QuadraticWorkload,
    RoundAnnounce,
    RoundBuffer,
    RoundRecord,
    RuntimeConfig,
    SHUTDOWN,
    TransportError,
    combine_weights,
    make_transport,
    parse_plan,
    protocol,
    run_client,
)
from repro_torch.runtime.actors import staleness_weight
from repro_torch.runtime.monitor import Monitor
from repro_torch.runtime.transport import ClientEndpoint

N, D, SEED = 6, 48, 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's small tensors: the test
    workers share the machine's cores, and idle intra-op threads spinning
    in every worker slow the others' wall-clock tests."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _fl(mechanism="aggregate_gaussian", **kw):
    base = dict(n_clients=N, mechanism=mechanism, sigma=1e-3, clip=2.0,
                cohort_fraction=0.8, straggler_fraction=0.2, lr=0.3,
                seed=SEED)
    base.update(kw)
    return FLConfig(**base)


def _runtime(cfg, wl):
    return AsyncFederatedRuntime(cfg, wl, device="cpu")


# ------------------------------------------------- sync/async equivalence
@pytest.mark.parametrize("mechanism,kwargs", [
    ("aggregate_gaussian", ()),
    ("individual_shifted", ()),
    ("irwin_hall", (("packed", True), ("msg_bits", 8))),
])
def test_async_staleness0_matches_sync_bitwise(mechanism, kwargs):
    fl = _fl(mechanism, mech_kwargs=kwargs)
    wl = QuadraticWorkload(N, D, seed=SEED)
    grad = wl.build(device="cpu")
    fa = FederatedAveraging(fl, grad, device="cpu")
    p_sync = wl.init_params(device="cpu")
    for rnd in range(4):
        p_sync, m = fa.round(p_sync, rnd)
    assert m["bits_per_coord"] > 0

    rt = _runtime(RuntimeConfig(fl=fl, staleness_bound=0, quorum=1.0,
                                round_timeout_s=30.0), wl)
    assert rt.proto == fa.proto
    p_async, summary, _ = rt.run(wl.init_params(device="cpu"), 4)
    assert summary["rounds"] == 4
    assert summary["mean_cohort_occupancy"] == 1.0
    assert p_async.dtype == np.float32
    np.testing.assert_array_equal(p_sync.numpy(), p_async)


def test_async_matches_the_reference_sync_loop():
    """The port's async run against the JAX package's synchronous loop on
    the same workload: the same cohorts and payloads; the decoded means
    differ by the decode's rounding (1e-6 each), so the params are held
    within 1e-5 after 4 rounds."""
    fl = _fl()
    jfa = jfl.FederatedAveraging(jfl.FLConfig(**dataclasses.asdict(fl)),
                                 lambda p, c, r: jgrad(p, c, r))
    jgrad = JQuad(N, D, seed=SEED).build()
    p_ref = JQuad(N, D, seed=SEED).init_params()
    for rnd in range(4):
        p_ref, _ = jfa.round(p_ref, rnd)
    wl = QuadraticWorkload(N, D, seed=SEED)
    p_async, _, records = _runtime(RuntimeConfig(fl=fl), wl).run(
        wl.init_params(device="cpu"), 4)
    assert [r.announced for r in records] == [
        len(jfl.sample_cohort(N, 0.8, 0.2, SEED, r)) for r in range(4)]
    np.testing.assert_allclose(p_async, np.asarray(p_ref), rtol=0,
                               atol=1e-5)


def test_protocol_straggler_renormalization():
    proto = protocol.RoundProtocol(mechanism="aggregate_gaussian",
                                   sigma=1e-3, clip=2.0, device="cpu")
    key = protocol.round_key(0, 0)
    xs = np.random.default_rng(0).uniform(-1, 1, (N, D)).astype(np.float32)
    msgs = torch.stack([proto.client_message(key, N, p, xs[p])
                        for p in range(N)])
    mask = np.array([True, True, False, True, False, True])
    y, bits = proto.decode(key, N, msgs, mask)
    err = y.numpy() - xs[mask].mean(0)
    assert np.abs(err).max() < 20 * proto.sigma
    assert 0 < bits < 32


# ------------------------------------------------------------- transport
@pytest.mark.parametrize("kind", ["thread", "process"])
def test_transport_integer_roundtrip_exact(kind):
    """A client actor behind each transport (the process one spawned)
    produces byte-identical integer payloads to a local encode."""
    fl = _fl(n_clients=2, cohort_fraction=1.0, straggler_fraction=0.0)
    proto = protocol.RoundProtocol(mechanism=fl.mechanism, sigma=fl.sigma,
                                   clip=fl.clip, device="cpu")
    wl = QuadraticWorkload(2, D, seed=SEED)
    transport = make_transport(kind, 2)
    specs = [ClientSpec(client_id=i, seed=fl.seed, proto=proto, workload=wl)
             for i in range(2)]
    transport.start_clients(run_client, specs)
    ep = transport.learner_endpoint()
    try:
        params = np.zeros(D, np.float32)
        ep.broadcast(RoundAnnounce(rnd=0, cohort=(0, 1), params=params))
        got = {}
        for _ in range(400):
            upd = ep.poll(timeout=0.25)
            if upd is not None:
                got[upd.cohort_pos] = upd
            if len(got) == 2:
                break
        assert len(got) == 2
        grad = wl.build(device="cpu")
        key = protocol.round_key(fl.seed, 0)
        for pos in (0, 1):
            want = proto.client_message(key, 2, pos,
                                        grad(torch.from_numpy(params), pos,
                                             0)).numpy()
            payload = got[pos].payload
            assert isinstance(payload, np.ndarray)
            assert payload.dtype == want.dtype == np.int32
            np.testing.assert_array_equal(payload, want)
            np.testing.assert_array_equal(
                got[pos].dither_seed,
                protocol.expected_dither_keys(key, 2)[pos])
    finally:
        ep.broadcast(SHUTDOWN)
        transport.shutdown()


def test_client_endpoint_drop_injection_and_retry():
    down, up = queue.Queue(), queue.Queue()
    ep = ClientEndpoint(0, down, up, drop_prob=0.9, drop_seed=1)
    upd = ClientUpdate(client_id=0, origin_round=0, cohort_pos=0,
                       payload=np.arange(4, dtype=np.int32),
                       dither_seed=np.zeros(2, np.uint32))
    raised = 0
    for attempt in range(50):
        try:
            ep.send(dataclasses.replace(upd, attempt=attempt))
            break
        except TransportError:
            raised += 1
    assert raised > 0 and up.qsize() == 1


def test_runtime_survives_lossy_transport():
    fl = _fl(cohort_fraction=1.0, straggler_fraction=0.0)
    wl = QuadraticWorkload(N, D, seed=SEED)
    _, summary, _ = _runtime(
        RuntimeConfig(fl=fl, quorum=1.0, round_timeout_s=30.0,
                      drop_prob=0.4, max_retries=8, retry_backoff_s=0.001),
        wl).run(wl.init_params(device="cpu"), 3)
    assert summary["rounds"] == 3
    assert summary["empty_rounds"] == 0
    assert summary["mean_cohort_occupancy"] == 1.0


# ---------------------------------------------------------- round buffer
def _upd(rnd, pos, cid=None, seed=None):
    return ClientUpdate(client_id=cid if cid is not None else pos,
                        origin_round=rnd, cohort_pos=pos,
                        payload=np.ones(3, np.int32),
                        dither_seed=seed if seed is not None
                        else np.asarray([rnd, pos], np.uint32))


def _register(buf, rnd, cohort):
    seeds = np.stack([np.asarray([rnd, p], np.uint32)
                      for p in range(len(cohort))])
    buf.register_round(rnd, cohort, seeds)


@pytest.mark.parametrize("cls", [RoundBuffer, jbuffer.RoundBuffer])
def test_buffer_staleness_and_validation(cls):
    """The reference's case, through both buffers alike."""
    buf = cls(staleness_bound=1)
    _register(buf, 0, (0, 1, 2))
    _register(buf, 1, (0, 2))
    _register(buf, 2, (1, 2))
    assert buf.offer(_upd(2, 0, cid=1), server_round=2) == "accepted"
    assert buf.offer(_upd(1, 1, cid=2), server_round=2) == "accepted"
    assert buf.offer(_upd(0, 0), server_round=2) == "stale"
    assert buf.offer(_upd(5, 0), server_round=2) == "unknown_round"
    assert buf.offer(_upd(2, 0, cid=0), server_round=2) == "bad_seed"
    assert buf.offer(_upd(2, 1, cid=2, seed=np.asarray([9, 9], np.uint32)),
                     server_round=2) == "bad_seed"
    assert buf.offer(_upd(2, 0, cid=1), server_round=2) == "duplicate"
    groups = buf.drain(server_round=2)
    assert sorted(groups) == [1, 2]
    assert list(groups[1]) == [1] and list(groups[2]) == [0]
    assert buf.size == 0
    assert buf.offer(_upd(0, 0), server_round=2) == "unknown_round"
    assert buf.stats.rejected_stale == 1
    assert buf.stats.duplicates == 1


def test_buffer_capacity_evicts_oldest_first():
    buf = RoundBuffer(staleness_bound=4, capacity=3)
    _register(buf, 0, (0, 1, 2))
    _register(buf, 1, (0, 1, 2))
    for rnd in (0, 1):
        for pos in range(2):
            buf.offer(_upd(rnd, pos), server_round=1)
    assert buf.size == 3 and buf.stats.evicted == 1
    assert buf.count(1) == 2
    assert buf.count(0) == 1


def test_staleness_weights_equal_the_reference():
    for s in range(5):
        for mode in ("uniform", "inverse"):
            assert staleness_weight(s, mode) == jbuffer.staleness_weight(
                s, mode)
    with pytest.raises(KeyError):
        staleness_weight(1, "exponential")
    for sizes in ({5: 3, 4: 1}, {5: 2, 4: 2, 3: 1}, {5: 0}):
        for mode in ("uniform", "inverse"):
            assert combine_weights(sizes, 5, mode) == \
                jbuffer.combine_weights(sizes, 5, mode)
    w = combine_weights({5: 3, 4: 1}, server_round=5, weighting="inverse")
    assert w[5] == pytest.approx(3.0 / 3.5)


# ------------------------------------------------------------ chaos plans
def test_fault_plans_decide_as_the_reference():
    """Every decision is a pure function of (seed, kind, client, round),
    the same in both packages; the seed matters."""
    kw = dict(client_crash_rate=0.5, drop_rate=0.4, duplicate_rate=0.3,
              delay_rate=0.2)
    grid = [(cid, rnd) for cid in range(6) for rnd in range(12)]

    def decisions(plan):
        return [(plan.client_crash(*g) is not None,
                 getattr(plan.transport_fault(*g), "kind", None),
                 plan.slow_uplink(*g), plan.learner_crash(g[1]))
                for g in grid]

    a = decisions(FaultPlan(seed=7, **kw))
    assert a == decisions(jchaos.FaultPlan(seed=7, **kw))
    assert a != decisions(FaultPlan(seed=8, **kw))
    assert any(x[0] for x in a) and any(x[1] for x in a)
    spec = "client_crash@1:2,learner_crash@3,drop@2:0,crash_rate=0.25"
    plan, jplan = (parse_plan(spec, seed=9, delay_s=0.5),
                   jchaos.parse_plan(spec, seed=9, delay_s=0.5))
    assert decisions(plan) == decisions(jplan)
    assert plan.any_faults and not FaultPlan().any_faults
    with pytest.raises(ValueError):
        parse_plan("explode@1")


def test_monitor_summary_equals_the_reference():
    recs = [dict(rnd=r, latency_s=0.1 * (r + 1), announced=4,
                 realized_current=4 - (r % 3 == 1), used_total=4 + (r == 2),
                 staleness_counts={0: 3, 1: 1} if r == 2 else {0: 4},
                 bits_total=100.0 * r, rejected_stale=r % 2,
                 rejected_other=0, update_norm=1.0, active_members=4,
                 evicted=int(r == 1), joined=int(r == 3))
            for r in range(6)]
    mon, jmon = Monitor(2.5), jmonitor.Monitor(2.5)
    for rec in recs:
        mon.emit(RoundRecord(**rec))
        jmon.emit(jmonitor.RoundRecord(**rec))
    assert mon.summary() == jmon.summary()
    mon.close()
    jmon.close()


# ------------------------------------------------------ fault scenarios
NC, DC = 4, 32


def _rc(**kw):
    base = dict(fl=_fl(n_clients=NC, cohort_fraction=1.0,
                       straggler_fraction=0.0),
                staleness_bound=0, quorum=1.0, round_timeout_s=30.0,
                transport="thread", heartbeat_timeout_s=None)
    base.update(kw)
    return RuntimeConfig(**base)


def _run(rc, rounds, wl=None):
    wl = wl or QuadraticWorkload(NC, DC, seed=SEED)
    return _runtime(rc, wl).run(wl.init_params(device="cpu"), rounds)


def _no_double_decode(records):
    for r in records:
        assert r.realized_current <= r.announced
        for cnt in r.staleness_counts.values():
            assert cnt <= r.announced + NC


def test_client_crash_eviction_completes():
    plan = FaultPlan(faults=(Fault("client_crash", rnd=1, client_id=2),))
    rc = _rc(chaos=plan, heartbeat_timeout_s=1.5, round_timeout_s=10.0)
    params, summary, records = _run(rc, 6)
    assert summary["rounds"] == 6
    assert summary["evictions"] == 1
    assert summary["active_members_final"] == NC - 1
    assert summary["degraded_rounds"] >= 1
    assert records[-1].announced == NC - 1
    assert records[-1].realized_current == NC - 1
    assert np.all(np.isfinite(params))
    _no_double_decode(records)


def test_client_crash_rejoin():
    pacing = tuple(Fault("slow_uplink", rnd=r, client_id=0, delay_s=0.4)
                   for r in range(2, 8))
    plan = FaultPlan(faults=(
        Fault("client_crash", rnd=1, client_id=1, rejoin_after_s=1.5),
    ) + pacing)
    rc = _rc(chaos=plan, heartbeat_timeout_s=1.2, round_timeout_s=10.0)
    params, summary, records = _run(rc, 8)
    assert summary["rounds"] == 8
    assert summary["evictions"] >= 1
    assert summary["joins"] >= 1
    assert summary["active_members_final"] == NC
    assert records[-1].announced == NC
    assert np.all(np.isfinite(params))


def test_learner_crash_recovers_from_checkpoint_bitwise(tmp_path):
    """The learner dies mid-round, restores the last committed
    {params, round} checkpoint (written in the JAX package's format) and
    re-runs the round: bitwise equal to the run without the fault."""
    ref_params, _, _ = _run(_rc(), 5)
    plan = FaultPlan(faults=(Fault("learner_crash", rnd=2),))
    rc = _rc(chaos=plan, checkpoint_dir=str(tmp_path), checkpoint_every=1)
    params, summary, records = _run(rc, 5)
    assert summary["learner_restarts"] == 1
    assert summary["rounds"] == 5
    np.testing.assert_array_equal(ref_params, params)
    _no_double_decode(records)


def test_resume_from_checkpoint_bitwise(tmp_path):
    """A run stopped after round 2 and resumed with ``resume=True`` lands
    bitwise on the uninterrupted run."""
    ref_params, _, _ = _run(_rc(), 5)
    ck = str(tmp_path)
    _run(_rc(checkpoint_dir=ck), 2)
    params, summary, records = _run(_rc(checkpoint_dir=ck, resume=True), 5)
    assert [r.rnd for r in records] == [2, 3, 4]
    np.testing.assert_array_equal(ref_params, params)


def test_drop_fault_degrades_exactly_one_round():
    plan = FaultPlan(faults=(Fault("drop", rnd=1, client_id=0),))
    rc = _rc(chaos=plan, round_timeout_s=3.0, heartbeat_timeout_s=10.0)
    params, summary, records = _run(rc, 4)
    assert summary["rounds"] == 4
    assert summary["degraded_rounds"] == 1
    assert records[1].realized_current == NC - 1
    assert summary["evictions"] == 0
    assert summary["active_members_final"] == NC
    _no_double_decode(records)


def test_delay_fault_exercises_staleness_path():
    plan = FaultPlan(faults=(Fault("delay", rnd=1, client_id=0,
                                   delay_s=3.0),))
    rc = _rc(chaos=plan, staleness_bound=1, quorum=0.7,
             round_timeout_s=2.0)
    params, summary, records = _run(rc, 5)
    assert summary["rounds"] == 5
    assert records[1].realized_current == NC - 1
    assert summary["stale_updates_used"] + summary["rejected_stale"] >= 1
    used = sum(r.used_total for r in records)
    assert used + summary["rejected_stale"] <= NC * 5
    _no_double_decode(records)


def test_duplicate_fault_decoded_once():
    plan = FaultPlan(faults=(Fault("duplicate", rnd=1, client_id=0),))
    params, summary, records = _run(_rc(chaos=plan, round_timeout_s=10.0),
                                    4)
    assert summary["rounds"] == 4
    assert records[1].realized_current == NC
    assert all(r.used_total <= r.announced for r in records)
    np.testing.assert_array_equal(_run(_rc(), 4)[0], params)


def test_slow_uplink_late_but_complete():
    plan = FaultPlan(faults=(Fault("slow_uplink", rnd=1, client_id=2,
                                   delay_s=0.4),))
    params, summary, records = _run(_rc(chaos=plan, round_timeout_s=10.0),
                                    3)
    assert summary["rounds"] == 3
    assert summary["mean_cohort_occupancy"] == 1.0
    assert records[1].latency_s >= 0.4
    _no_double_decode(records)


def test_wallclock_stragglers_rejected_at_bound0_used_at_bound2():
    def summary(bound):
        fl = _fl(cohort_fraction=1.0, straggler_fraction=0.0, n_clients=4)
        rc = RuntimeConfig(fl=fl, staleness_bound=bound,
                           staleness_weighting="inverse", quorum=0.5,
                           round_timeout_s=1.0, straggler_fraction=0.5,
                           straggler_delay_s=2.0)
        return _run(rc, 8, QuadraticWorkload(4, D, seed=SEED))[1]

    s0 = summary(0)
    assert s0["rounds"] == 8
    assert s0["stale_updates_used"] == 0
    assert s0["rejected_stale"] > 0
    s2 = summary(2)
    assert s2["rounds"] == 8
    assert s2["stale_updates_used"] > 0
    assert max(int(k) for k in s2["staleness_hist"]) <= 2


class SlowFirstGradWorkload:
    """QuadraticWorkload whose first grad call per client blocks for
    ``stall_s``, pinning the client actor's main thread."""

    def __init__(self, n_clients, d, seed=0, stall_s=1.2):
        self.inner = QuadraticWorkload(n_clients, d, seed=seed)
        self.stall_s = stall_s

    def init_params(self, device=None):
        return self.inner.init_params(device)

    def build(self, device=None):
        import time as _time

        inner_grad = self.inner.build(device)
        stalled = set()

        def grad(flat, client_id, rnd):
            if client_id not in stalled:
                stalled.add(client_id)
                _time.sleep(self.stall_s)
            return inner_grad(flat, client_id, rnd)

        return grad


def test_heartbeat_sidecar_survives_a_long_first_round(monkeypatch):
    """A first-round stall twice the heartbeat timeout gets no client
    evicted (the sidecar beacon keeps beaconing); with the sidecar
    silenced, the same stall does evict."""
    from repro_torch.runtime import actors

    def run():
        rc = _rc(heartbeat_timeout_s=1.2, round_timeout_s=15.0)
        return _run(rc, 3, SlowFirstGradWorkload(NC, DC, seed=SEED,
                                                 stall_s=2.4))

    params, summary, records = run()
    assert summary["rounds"] == 3
    assert summary["evictions"] == 0
    assert records[0].realized_current == NC
    assert np.all(np.isfinite(params))
    monkeypatch.setattr(actors._HeartbeatBeacon, "_run", lambda self: None)
    assert run()[1]["evictions"] >= 1
