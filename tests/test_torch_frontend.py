"""Parity of the port's serving frontend with the JAX package, on the CPU:
``repro_torch.serving.ServingFrontend`` against the reference
``repro.serving.ServingFrontend`` run with no mesh, in f32, on reduced
gemma3-1b carried through the bridge, with the same traces, the same
seeded ``FaultInjector`` schedules and the same injected clock.

Held equal: the FINISHED tokens, every ticket's status, error and
recovery count, the frontend's recoveries, the injector's log and the
integer ``EngineStats`` counters; on a contiguous, a paged and a
speculating engine, over reduced gemma3-1b and reduced mixtral-8x22b.
Then the lifecycle the reference's own tests pin (backpressure,
deadlines, cancellation, the recovery cap, drains, the threaded serve
loop), each scenario run through both packages.
"""

import threading
import types

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

import repro.configs as RC  # noqa: E402
from repro.launch.serve import merge_model  # noqa: E402
from repro.models.lm import LM as RLM  # noqa: E402
from repro import runtime as rruntime  # noqa: E402
from repro import serving as rserving  # noqa: E402
from repro.serving import frontend as rfrontend  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
from repro_torch import bridge, runtime, serving  # noqa: E402
from repro_torch.models.lm import LM as TLM  # noqa: E402
from repro_torch.serving import frontend  # noqa: E402
from _torch_parity import numpy_tree  # noqa: E402

# integer counters both packages' EngineStats keep (the port adds
# ragged_dispatches and ragged_seconds)
COUNTERS = ("model_steps", "dispatches", "tokens_out", "slot_steps",
            "busy_slot_steps", "proposed_tokens", "accepted_tokens")
JOIN_S = 60.0  # a threaded test fails, never hangs, past this


@pytest.fixture(scope="module")
def served():
    rcfg, tcfg = RC.reduced("gemma3-1b"), TC.reduced("gemma3-1b")
    rlm = RLM(rcfg)
    merged = merge_model(rlm.init(jax.random.PRNGKey(0)), rcfg.quant)
    return types.SimpleNamespace(
        rcfg=rcfg, rlm=rlm, merged=merged, tlm=TLM(tcfg),
        tmerged=bridge.load_numpy_tree(numpy_tree(merged), tcfg, "cpu"))


def _sides(served):
    """(serving module, runtime module, lm, tree) of the reference and the
    port."""
    return {"ref": (rserving, rruntime, served.rlm, served.merged),
            "port": (serving, runtime, served.tlm, served.tmerged)}


class FakeClock:
    """Deterministic injectable clock: time moves only through advance()."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _trace(served, n=6):
    return serving.make_trace(n, served.rcfg.vocab, seed=3,
                              prompt_lens=(3, 5, 8), gen_lens=(4, 9, 6))


ENGINE = dict(n_slots=2, max_len=24, prefill_chunk=4, decode_burst=2)
MODES = {"contiguous": {}, "paged": dict(page_size=4),
         "speculating": dict(decode_burst=1, speculate=2,
                             drafter="*=intq8")}


def _drain(mod, lm, tree, trace, injector=None, **kw):
    """A trace through a frontend, driven on this thread to the end;
    returns the frontend."""
    fe = mod.ServingFrontend(lm, tree, **{**ENGINE, "queue_cap": len(trace),
                                          "injector": injector, **kw})
    for r in trace:
        fe.submit(r.prompt, r.max_new_tokens, eos_id=r.eos_id, rid=r.rid)
    fe.run_until_drained()
    return fe


def _finished(fe):
    return {t.rid: list(t.tokens) for t in fe.tickets.values()
            if t.status.name == "FINISHED"}


def _tickets(fe):
    return {t.rid: (t.status.name, t.error, list(t.tokens), t.n_recoveries)
            for t in fe.tickets.values()}


def _counters(stats):
    return {k: getattr(stats, k) for k in COUNTERS}


def _injectors(mod):
    return {"clean": None,
            "crash+nan": mod.FaultInjector(seed=0, crash_steps=(3,),
                                           nan_steps=(6,)),
            "crashes": mod.FaultInjector(seed=0, crash_steps=(3, 9, 14))}


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("faults", ("clean", "crash+nan", "crashes"))
def test_frontend_matches_reference(served, mode, faults):
    """The same trace and fault schedule through both frontends: tickets
    (status, error, tokens, recoveries), the frontend's recoveries, the
    injector's log and the engines' counters equal; the recovered streams
    are the clean run's and the plain engine's."""
    trace = _trace(served)
    got = {}
    for side, (mod, rt, lm, tree) in _sides(served).items():
        inj = _injectors(rt)[faults]
        fe = _drain(mod, lm, tree, trace, injector=inj, **MODES[mode])
        got[side] = (fe, inj)
    (fe, inj), (rfe, rinj) = got["port"], got["ref"]
    assert _tickets(fe) == _tickets(rfe)
    assert fe.n_recoveries == rfe.n_recoveries
    assert [e.split("(")[0] for _, e in fe.fault_log] \
        == [e.split("(")[0] for _, e in rfe.fault_log]
    assert _counters(fe.engine_stats) == _counters(rfe.engine_stats)
    assert fe.status_counts() == {"FINISHED": len(trace)}
    eng = serving.ContinuousEngine(served.tlm, served.tmerged,
                                   **{**ENGINE, **MODES[mode]})
    for r in trace:
        eng.submit(r.prompt, r.max_new_tokens, r.eos_id, rid=r.rid)
    assert _finished(fe) == eng.run()
    if faults == "clean":
        assert fe.n_recoveries == 0 and fe.fault_log == []
        return
    assert inj.log == rinj.log
    assert fe.n_recoveries == len([k for _, k in inj.log
                                   if k in ("crash", "nan")])
    kinds = {e.split("(")[0] for _, e in fe.fault_log}
    assert kinds <= {"InjectedFault", "EngineCorrupted"}
    assert any(t.n_recoveries >= 1 for t in fe.tickets.values())
    # the counters of the engine before each reset survive it
    assert fe.engine_stats.ragged_dispatches \
        > fe.engine.stats.ragged_dispatches
    if MODES[mode].get("page_size"):
        fe.engine.page_table.check_invariants()
        assert fe.engine.page_table.n_used == 0


@pytest.fixture(scope="module")
def moe_served():
    rcfg, tcfg = RC.reduced("mixtral-8x22b"), TC.reduced("mixtral-8x22b")
    rlm = RLM(rcfg)
    merged = merge_model(rlm.init(jax.random.PRNGKey(0)), rcfg.quant)
    return types.SimpleNamespace(
        rcfg=rcfg, rlm=rlm, merged=merged, tlm=TLM(tcfg),
        tmerged=bridge.load_numpy_tree(numpy_tree(merged), tcfg, "cpu"))


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("faults", ("clean", "crash+nan", "crashes"))
def test_moe_frontend_matches_reference(moe_served, mode, faults):
    """Both frontends over a reduced mixtral engine (contiguous, paged,
    speculating): tickets, recoveries, the injector's log, the fault log's
    kinds and the engines' counters equal.  The clean run gives the plain
    engine's streams; a recovered request is prefilled again in another
    batch, and capacity routing makes its experts depend on that batch,
    so its later tokens may differ from the clean run's, in both packages
    alike."""
    trace = _trace(moe_served)
    got = {}
    for side, (mod, rt, lm, tree) in _sides(moe_served).items():
        inj = _injectors(rt)[faults]
        got[side] = (_drain(mod, lm, tree, trace, injector=inj,
                            **MODES[mode]), inj)
    (fe, inj), (rfe, rinj) = got["port"], got["ref"]
    assert _tickets(fe) == _tickets(rfe)
    assert fe.n_recoveries == rfe.n_recoveries
    assert [e.split("(")[0] for _, e in fe.fault_log] \
        == [e.split("(")[0] for _, e in rfe.fault_log]
    assert _counters(fe.engine_stats) == _counters(rfe.engine_stats)
    assert fe.status_counts() == {"FINISHED": len(trace)}
    if faults == "clean":
        eng = serving.ContinuousEngine(moe_served.tlm, moe_served.tmerged,
                                       **{**ENGINE, **MODES[mode]})
        for r in trace:
            eng.submit(r.prompt, r.max_new_tokens, r.eos_id, rid=r.rid)
        assert _finished(fe) == eng.run()
        assert fe.n_recoveries == 0
        return
    assert inj.log == rinj.log
    assert fe.n_recoveries == len([k for _, k in inj.log
                                   if k in ("crash", "nan")])
    if MODES[mode].get("page_size"):
        fe.engine.page_table.check_invariants()
        assert fe.engine.page_table.n_used == 0


def test_stragglers_change_latency_not_tokens(served):
    """Injected sleeps land in the engine's seconds, not in its streams."""
    trace = _trace(served)
    clean = _drain(serving, served.tlm, served.tmerged, trace)
    slept = []
    inj = runtime.FaultInjector(seed=0, straggle_steps=(2, 4, 6),
                                straggle_s=0.003, sleep=slept.append)
    fe = _drain(serving, served.tlm, served.tmerged, trace, injector=inj)
    assert _finished(fe) == _finished(clean)
    assert fe.n_recoveries == 0 and slept == [0.003] * 3
    assert inj.log == [(2, "straggle"), (4, "straggle"), (6, "straggle")]


def test_sum_stats_keeps_every_counter():
    """Every field of the port's EngineStats, the ragged ones too, is
    summed across a reset."""
    import dataclasses
    names = [f.name for f in dataclasses.fields(serving.EngineStats)]
    a = serving.EngineStats(**{n: i + 1 for i, n in enumerate(names)})
    b = serving.EngineStats(**{n: 10 * (i + 1) for i, n in enumerate(names)})
    s = frontend._sum_stats(a, b)
    assert {n: getattr(s, n) for n in names} == {
        n: 11 * (i + 1) for i, n in enumerate(names)}
    assert {"ragged_dispatches", "ragged_seconds"} <= set(names)


# ---------------------------------------------------------------------------
# lifecycle scenarios, each through both packages
# ---------------------------------------------------------------------------


def _both(served, scenario, **kw):
    """``scenario(fe, clock, rt)`` on a frontend of each package built with
    ``kw`` and a FakeClock; returns {side: (tickets, status counts, what
    the scenario returned)}."""
    out = {}
    for side, (mod, rt, lm, tree) in _sides(served).items():
        clk = FakeClock()
        fe = mod.ServingFrontend(lm, tree, **{**ENGINE, "clock": clk, **kw})
        extra = scenario(fe, clk, rt)
        out[side] = (_tickets(fe), fe.status_counts(), extra)
    assert out["port"] == out["ref"]
    return out["port"]


def test_deadlines_under_a_fake_clock(served):
    """A running request past its total deadline is evicted (TIMED_OUT,
    partial tokens kept); one past its TTFT deadline times out in the
    queue; the deadline-free ones finish: status for status, error for
    error, as the reference's."""
    def scenario(fe, clk, rt):
        fe.submit(np.array([5, 6, 7], np.int32), 12, deadline_s=5.0)
        fe.submit(np.array([8, 9], np.int32), 3)
        fe.submit(np.array([10, 11], np.int32), 4, ttft_deadline_s=1.0)
        fe.step()          # the prefill dispatch
        fe.step()          # a decode burst commits tokens
        clk.advance(6.0)   # past both deadlines
        fe.run_until_drained()
    tickets, counts, _ = _both(served, scenario, n_slots=1)
    assert counts == {"TIMED_OUT": 2, "FINISHED": 1}
    status, err, toks, _ = tickets[0]
    assert "total deadline" in err and 0 < len(toks) < 12
    assert "TTFT deadline" in tickets[2][1] and "queued" in tickets[2][1]
    assert tickets[1][0] == "FINISHED" and len(tickets[1][2]) == 3


def test_default_deadlines_and_ttft_in_intake(served):
    def scenario(fe, clk, rt):
        fe.submit(np.array([5, 6], np.int32), 4)
        clk.advance(2.0)   # expires in the intake queue
        fe.submit(np.array([7, 8], np.int32), 4, ttft_deadline_s=99.0)
        fe.run_until_drained()
        return [(t.deadline_s, t.ttft_deadline_s)
                for t in fe.tickets.values()]
    tickets, counts, limits = _both(served, scenario,
                                    default_ttft_deadline_s=1.0,
                                    default_deadline_s=7.0)
    assert counts == {"TIMED_OUT": 1, "FINISHED": 1}
    assert limits == [(7.0, 1.0), (7.0, 99.0)]
    assert tickets[0][2] == []


def test_cancel_queued_and_in_flight(served):
    def scenario(fe, clk, rt):
        running = fe.submit(np.array([5, 6, 7], np.int32), 10)
        queued = fe.submit(np.array([8, 9], np.int32), 5)
        late = fe.submit(np.array([4, 9], np.int32), 5)
        assert fe.cancel(queued.rid)      # still in the intake
        fe.step()
        fe.step()
        assert running.status.name == "RUNNING"
        assert fe.cancel(running.rid) and fe.cancel(late.rid)
        fe.run_until_drained()
        return fe.cancel(running.rid)     # already terminal
    tickets, counts, again = _both(served, scenario, n_slots=1)
    assert counts == {"CANCELLED": 3} and again is False
    assert "in flight" in tickets[0][1] and 0 < len(tickets[0][2]) < 10
    assert "queued" in tickets[1][1] and tickets[1][2] == []
    assert "queued" in tickets[2][1]


def test_backpressure_names_the_queue_depth(served):
    def scenario(fe, clk, rt):
        for i in range(6):
            fe.submit(np.array([4 + i, 9], np.int32), 2)
        fe.run_until_drained()
    tickets, counts, _ = _both(served, scenario, queue_cap=3)
    assert counts == {"FINISHED": 3, "REJECTED": 3}
    for rid in (3, 4, 5):
        assert "backpressure" in tickets[rid][1] \
            and "depth 3/3" in tickets[rid][1]


def test_invalid_requests_reject_not_raise(served):
    def scenario(fe, clk, rt):
        fe.submit(np.array([], np.int32), 4)
        fe.submit(np.array([5], np.int32), 0)
        fe.submit(np.array([5, 6, 7], np.int32), 99)
        fe.submit(np.array([5, 6], np.int32), 2, adapter_id="nobody")
        ok = fe.submit(np.array([5, 6, 7], np.int32), 4)
        with pytest.raises(ValueError, match="duplicate rid"):
            fe.submit(np.array([5], np.int32), 2, rid=ok.rid)
        fe.run_until_drained()
    tickets, counts, _ = _both(served, scenario, max_len=10)
    assert counts == {"REJECTED": 4, "FINISHED": 1}
    for rid, frag in ((0, "empty prompt"), (1, "max_new_tokens"),
                      (2, "cache positions"), (3, "no AdapterStore")):
        assert frag in tickets[rid][1]


def test_recovery_cap_goes_failed_then_rejected(served):
    def scenario(fe, clk, rt):
        fe.submit(np.array([5, 6, 7], np.int32), 5)
        fe.run_until_drained()
        late = fe.submit(np.array([5], np.int32), 2)
        return (fe.n_recoveries, fe.fatal is not None, late.status.name,
                "failed" in late.error)

    out = {}
    for side, (mod, rt, lm, tree) in _sides(served).items():
        fe = mod.ServingFrontend(lm, tree, **ENGINE, max_recoveries=2,
                                 injector=rt.FaultInjector(seed=0,
                                                           p_crash=1.0))
        out[side] = (scenario(fe, None, rt), _tickets(fe))
    assert out["port"] == out["ref"]
    (n, fatal, late, named), tickets = out["port"]
    assert (n, fatal, late, named) == (3, True, "REJECTED", True)
    assert tickets[0][0] == "FAILED" and "unrecoverable" in tickets[0][1]


def test_preemption_drain_cancels_the_undispatched_queue(served):
    def scenario(fe, clk, rt):
        fe.guard = rt.PreemptionGuard()
        fe.submit(np.array([5, 6, 7], np.int32), 4)
        fe.submit(np.array([8, 9], np.int32), 4)
        fe.step()                  # the first request reaches the slot
        fe.guard.requested = True  # what the SIGTERM handler flips
        fe.run_until_drained()
        fe.submit(np.array([10], np.int32), 2)
    tickets, counts, _ = _both(served, scenario, n_slots=1)
    assert counts == {"FINISHED": 1, "CANCELLED": 1, "REJECTED": 1}
    assert len(tickets[0][2]) == 4
    assert "preemption" in tickets[1][1] and "draining" in tickets[2][1]


def test_stop_finishes_the_accepted_queue(served):
    def scenario(fe, clk, rt):
        for i in range(3):
            fe.submit(np.array([5 + i, 6], np.int32), 2)
        counts = fe.stop()
        fe.submit(np.array([9], np.int32), 2)
        return counts
    tickets, counts, at_stop = _both(served, scenario, n_slots=1)
    assert at_stop == {"FINISHED": 3}
    assert "draining" in tickets[3][1]


def test_threaded_live_intake_drains_clean(served):
    """start() / stop() with submissions from a feeder thread: every
    request FINISHED with the synchronous run's tokens, and both threads
    end within their joins."""
    trace = serving.make_trace(6, served.rcfg.vocab, seed=4,
                               prompt_lens=(3, 7), gen_lens=(3, 5))
    sync = _drain(serving, served.tlm, served.tmerged, trace)
    fe = serving.ServingFrontend(served.tlm, served.tmerged, **ENGINE,
                                 queue_cap=len(trace)).start()
    serve_thread = fe._thread
    with pytest.raises(RuntimeError, match="already started"):
        fe.start()

    def feed():
        for r in trace:
            fe.submit(r.prompt, r.max_new_tokens, rid=r.rid)

    feeder = threading.Thread(target=feed, daemon=True)
    feeder.start()
    feeder.join(JOIN_S)
    assert not feeder.is_alive()
    counts = fe.stop(timeout=JOIN_S)
    assert not serve_thread.is_alive()
    assert counts == {"FINISHED": len(trace)}
    assert _finished(fe) == _finished(sync)
    assert fe.wall_s > 0.0
    assert fe.engine_stats.tokens_out == sum(r.max_new_tokens
                                             for r in trace)
    assert fe.result(0, timeout=0.0).done.is_set()


def test_threaded_recovery_and_replay(served):
    """The serve thread recovers an injected crash while a feeder replays
    the trace at seeded Poisson arrivals: every ticket FINISHED, tokens
    the synchronous clean run's."""
    trace = _trace(served)
    clean = _drain(serving, served.tlm, served.tmerged, trace)
    inj = runtime.FaultInjector(seed=0, crash_steps=(4,))
    fe = serving.ServingFrontend(served.tlm, served.tmerged, **ENGINE,
                                 injector=inj, queue_cap=len(trace)).start()
    serve_thread = fe._thread
    arrivals = serving.poisson_arrivals(len(trace), 2000.0, seed=1)
    serving.replay(lambda r: fe.submit(r.prompt, r.max_new_tokens,
                                       rid=r.rid), trace, arrivals)
    fe.stop(timeout=JOIN_S)
    assert not serve_thread.is_alive()
    assert fe.status_counts() == {"FINISHED": len(trace)}
    assert _finished(fe) == _finished(clean)
    assert fe.n_recoveries == 1 and inj.log == [(4, "crash")]


def test_slo_summary_matches_reference_on_hand_built_tickets():
    """The same tickets (statuses, stamps, tokens) through both packages'
    ``slo_summary``: equal rollups, percentiles over FINISHED tickets
    only."""
    rows = [("FINISHED", 0.0, 0.10, 0.50, 5), ("FINISHED", 0.2, 0.25, 0.45, 3),
            ("FINISHED", 0.1, 0.40, 0.40, 1), ("TIMED_OUT", 0.0, 0.3, 1.0, 2),
            ("REJECTED", 0.3, None, 0.3, 0), ("FINISHED", 0.5, 0.9, 1.7, 9)]

    def summary(mod, fe_mod):
        tickets = {}
        for i, (st, t0, t1, t2, n) in enumerate(rows):
            t = fe_mod.Ticket(rid=i, prompt=np.zeros(1, np.int32),
                              max_new_tokens=9, t_submit=t0)
            t.status = fe_mod.RequestStatus[st]
            t.t_first, t.t_done, t.tokens = t1, t2, list(range(n))
            tickets[i] = t
        fe = types.SimpleNamespace(tickets=tickets, wall_s=2.0,
                                   n_recoveries=1)
        return mod.slo_summary(fe)

    got = summary(serving, frontend)
    ref = summary(rserving, rfrontend)
    assert got == pytest.approx(ref, nan_ok=True)
    assert got["finished"] == 4 and got["timeout_rate"] == 1 / 6
    assert got["goodput_tok_s"] == (5 + 3 + 1 + 9) / 2.0
    assert got["ttft_p50_s"] == pytest.approx(
        np.percentile([0.1, 0.05, 0.3, 0.4], 50))


def test_frontend_refuses_what_the_port_does_not_serve(served):
    with pytest.raises(NotImplementedError, match="cache_dtype"):
        serving.ServingFrontend(served.tlm, served.tmerged, **ENGINE,
                                cache_dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="max_src"):
        serving.ServingFrontend(served.tlm, served.tmerged, **ENGINE,
                                max_src=8)
    fe = serving.ServingFrontend(served.tlm, served.tmerged, **ENGINE,
                                 cache_dtype=torch.float32)
    t = fe.submit(np.array([5, 6], np.int32), 2,
                  src=np.zeros((2, 4), np.float32))
    ok = fe.submit(np.array([5, 6], np.int32), 2)
    fe.run_until_drained()
    assert t.status.name == "REJECTED" and "encdec" in t.error
    assert ok.status.name == "FINISHED"


def test_port_serving_exports_the_reference_frontend_names():
    names = {"RequestStatus", "ServingFrontend", "Ticket",
             "TERMINAL_STATUSES", "slo_summary"}
    assert names <= set(rserving.__all__) and names <= set(serving.__all__)
    assert sorted(serving.__all__) == sorted(rserving.__all__)
    assert {s.name for s in serving.RequestStatus} \
        == {s.name for s in rserving.RequestStatus}
    assert {s.name for s in serving.TERMINAL_STATUSES} \
        == {s.name for s in rserving.TERMINAL_STATUSES}
