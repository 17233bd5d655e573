"""The port's fault-injection and liveness pieces against the JAX package's,
on the CPU: ``FaultInjector``'s seeded schedule draw for draw,
``Heartbeat``'s liveness cases, and the engine's ``step_hook`` (called once
an iteration before admission, surviving ``reset()``, committing nothing
when it raises) with ``poison_cache`` reaching the contiguous cache and the
paged pool.  Plus: ``frontend.py`` and ``fault.py`` import neither jax nor
the reference, and ``repro_torch.runtime`` exports the reference's names.
"""

import ast
import json
import os
import time
import types
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from repro import runtime as rruntime  # noqa: E402
from repro.runtime import fault as rfault  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
from repro_torch import runtime, serving  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models.lm import LM as TLM  # noqa: E402
from repro_torch.runtime import fault  # noqa: E402


# ---------------------------------------------------------------------------
# FaultInjector
# ---------------------------------------------------------------------------


SCHEDULES = (
    dict(seed=0, p_crash=0.01, p_nan=0.02, p_straggle=0.1),
    dict(seed=7, p_crash=0.2, p_nan=0.3, p_straggle=0.5),
    dict(seed=2, crash_steps=(8,), p_straggle=0.05, straggle_s=0.01),
    dict(seed=3, crash_steps=(0, 999), nan_steps=(5, 6), straggle_steps=(1,),
         p_crash=0.05, p_nan=0.05, p_straggle=0.05),
)


@pytest.mark.parametrize("kw", SCHEDULES)
def test_injector_schedule_is_the_reference_draw_for_draw(kw):
    """Over 1000 dispatches both injectors name the same fault (or none)
    at every dispatch, and their logs are equal."""
    class Engine:
        def __init__(self):
            self.poisoned = 0

        def poison_cache(self):
            self.poisoned += 1

    runs = {}
    for mod in (fault, rfault):
        slept, eng, kinds = [], Engine(), []
        inj = mod.FaultInjector(**kw, sleep=slept.append)
        for _ in range(1000):
            try:
                inj(eng)
                kinds.append(inj.log[-1][1] if inj.log
                             and inj.log[-1][0] == inj.step else None)
            except mod.InjectedFault as e:
                kinds.append("crash")
                assert f"dispatch {inj.step}" in str(e)
        runs[mod.__name__] = (kinds, list(inj.log), len(slept),
                              eng.poisoned, inj.step)
    got, ref = runs[fault.__name__], runs[rfault.__name__]
    assert got == ref
    kinds, log, n_slept, n_poisoned, last = got
    assert last == 999 and len(kinds) == 1000
    assert n_slept == kinds.count("straggle")
    assert n_poisoned == kinds.count("nan")
    assert len(log) == 1000 - kinds.count(None)


def test_injector_schedule_is_step_pure():
    """``next_fault`` alone (no hook) gives the same kinds as the hook:
    three draws a dispatch whatever fires, and an explicit step fires
    once."""
    kw = dict(seed=5, crash_steps=(3,), p_nan=0.1, p_straggle=0.2)
    a = fault.FaultInjector(**kw)
    b = rfault.FaultInjector(**kw)
    seq = [a.next_fault() for _ in range(200)]
    assert seq == [b.next_fault() for _ in range(200)]
    assert seq[3] == "crash" and seq.count("crash") == 1
    assert {"nan", "straggle", None} <= set(seq)


# ---------------------------------------------------------------------------
# Heartbeat
# ---------------------------------------------------------------------------


def test_heartbeat_liveness_cases(tmp_path):
    """Alive while beating; dead once the beat is older than the timeout;
    dead for a missing file and for a malformed one; each as the
    reference's ``is_alive`` says."""
    path = str(tmp_path / "hb.json")
    hb = fault.Heartbeat(path, host_id=3, interval=0.01).start()
    try:
        deadline = time.monotonic() + 10
        while not os.path.exists(path) and time.monotonic() < deadline:
            time.sleep(0.01)
        assert json.load(open(path))["host"] == 3
        cases = {"beating": path}
    finally:
        hb.stop()
    assert not hb._thread.is_alive()
    stale = tmp_path / "stale.json"
    stale.write_text(json.dumps({"host": 0, "t": time.time() - 60}))
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    nokey = tmp_path / "nokey.json"
    nokey.write_text(json.dumps({"host": 0}))
    cases.update(stale=str(stale), missing=str(tmp_path / "none.json"),
                 malformed=str(bad), no_stamp=str(nokey))
    got = {k: fault.Heartbeat.is_alive(p, timeout=30.0)
           for k, p in cases.items()}
    assert got == {k: rfault.Heartbeat.is_alive(p, timeout=30.0)
                   for k, p in cases.items()}
    assert got == {"beating": True, "stale": False, "missing": False,
                   "malformed": False, "no_stamp": False}
    assert not fault.Heartbeat.is_alive(path, timeout=0.0)


# ---------------------------------------------------------------------------
# the engine's step hook and poison_cache
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def model():
    cfg = TC.reduced("gemma3-1b")
    lm = TLM(cfg)
    params = lm.init(torch.Generator().manual_seed(0), "cpu")
    return types.SimpleNamespace(lm=lm, merged=tserve.merge_model(params))


def _engine(model, **kw):
    return serving.ContinuousEngine(model.lm, model.merged, **{
        "n_slots": 1, "max_len": 16, "prefill_chunk": 4, "decode_burst": 2,
        **kw})


def test_step_hook_runs_before_admission_and_survives_reset(model):
    seen = []

    def hook(eng):
        seen.append((len(eng.sched.queue), eng.sched.slots[0] is None))

    eng = _engine(model, step_hook=hook)
    eng.submit(np.array([5, 6, 7], np.int32), 4, rid=0)
    eng.step_once()
    assert seen == [(1, True)]          # before the request was admitted
    eng.reset()
    assert eng.step_hook is hook
    eng.submit(np.array([5, 6, 7], np.int32), 4, rid=0)
    out = eng.run()
    assert len(out[0]) == 4 and len(seen) == 1 + eng.stats.dispatches
    assert seen[1] == (1, True)


def test_failed_step_commits_nothing(model):
    """A crash from the hook leaves the emitted streams and the queue as
    they were, on the port's engine as on the reference's."""
    eng = _engine(model, step_hook=runtime.FaultInjector(seed=0,
                                                         crash_steps=(2,)))
    eng.submit(np.array([5, 6, 7], np.int32), 6, rid=0)
    eng.submit(np.array([8, 9], np.int32), 2, rid=1)
    eng.step_once()                       # 0: prefill
    eng.step_once()                       # 1: a burst commits
    before = list(eng.sched.slots[0].emitted)
    assert before
    with pytest.raises(runtime.InjectedFault, match="dispatch 2"):
        eng.step_once()                   # 2: the crash, before admission
    assert list(eng.sched.slots[0].emitted) == before
    assert [r.rid for r in eng.sched.queue] == [1]


@pytest.mark.parametrize("mode", ({}, dict(page_size=4),
                                  dict(page_size=4, decode_burst=1,
                                       speculate=2, drafter="*=intq8")))
def test_poison_reaches_the_pool_and_reset_clears_it(model, mode):
    """``poison_cache`` fills the contiguous cache's K/V rows or the whole
    page pool with NaN in place; the next step raises ``EngineCorrupted``
    with nothing committed; ``reset()`` zeroes every row of the target's
    cache and the drafter's at their addresses, and the engine serves the
    same stream again."""
    clean = _engine(model, n_slots=2, **mode)
    clean.submit(np.array([5, 6, 7], np.int32), 6, rid=0)
    want = clean.run()[0]
    eng = _engine(model, n_slots=2, **mode)
    ptrs = [t.data_ptr() for c in eng._caches()
            for t in c["layers"].values()]
    eng.submit(np.array([5, 6, 7], np.int32), 6, rid=0)
    eng.step_once()
    eng.step_once()
    before = list(eng.sched.slots[0].emitted)
    eng.poison_cache()
    assert all(torch.isnan(t).all() for t in eng.cache["layers"].values())
    with pytest.raises(serving.EngineCorrupted):
        eng.step_once()
    assert list(eng.sched.slots[0].emitted) == before
    eng.reset()
    for c in eng._caches():
        assert all((t == 0).all() for t in c["layers"].values())
        assert (c["len"] == 0).all()
    assert ptrs == [t.data_ptr() for c in eng._caches()
                    for t in c["layers"].values()]
    eng.submit(np.array([5, 6, 7], np.int32), 6, rid=0)
    assert eng.run()[0] == want


# ---------------------------------------------------------------------------
# what the modules import and export
# ---------------------------------------------------------------------------


def test_frontend_and_fault_import_no_jax():
    root = Path(fault.__file__).parents[1]
    for path in (root / "serving" / "frontend.py", root / "runtime" /
                 "fault.py", root / "runtime" / "__init__.py"):
        mods = set()
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                mods |= {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.module:
                mods.add(node.module.split(".")[0])
        assert not mods & {"jax", "repro"}, (path.name, mods)


def test_port_runtime_exports_the_reference_names():
    def public(mod):
        return {n for n in dir(mod) if not n.startswith("_")
                and isinstance(getattr(mod, n), type)}
    assert public(runtime) == public(rruntime)
    assert {"Heartbeat", "FaultInjector", "InjectedFault",
            "PreemptionGuard", "RestartableLoop", "StragglerDetector",
            "CompileGuard", "CompileBudgetExceeded"} <= public(runtime)
    assert issubclass(runtime.InjectedFault, RuntimeError)
