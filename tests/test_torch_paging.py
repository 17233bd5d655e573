"""Parity of the port's paged KV cache with the JAX package, on the CPU: the
page table (the reference's properties, then op for op against the
reference's), the paged scheduler, the paged insert and gather, the paged
ragged step, and the paged continuous engine against the port's contiguous
engine and the reference's ``ContinuousEngine(page_size=...)`` run with no
mesh.

Inputs are made with numpy from seeds and given to both packages; trees
go to the port through ``repro_torch.bridge``.
"""

import ast
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).parent))
try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # deterministic fallback sweep (see _hypothesis_compat)
    from _hypothesis_compat import given, settings, strategies as st

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import repro.configs as RC  # noqa: E402
from repro.core import schemes as RS  # noqa: E402
from repro.launch.serve import merge_model  # noqa: E402
from repro.models import attention as RA  # noqa: E402
from repro.models.lm import LM as RLM  # noqa: E402
from repro import serving as rserving  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
from repro_torch import bridge, serving  # noqa: E402
from repro_torch.core import schemes as TS  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models.lm import LM as TLM  # noqa: E402
from repro_torch.serving import PageTable, pages_for  # noqa: E402
from repro_torch.serving.paging import NULL_PAGE  # noqa: E402
from _torch_parity import numpy_tree  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch"
TOL = 1e-4  # logits, as tests/test_torch_serve.py


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _prompt(rng, n, shared=0):
    """Random prompt of n tokens; the first ``shared`` tokens are a fixed
    vector, so prompts with the same shared length hit each other's
    registered prefix pages."""
    p = rng.integers(100, 200, size=(n,)).astype(np.int32)
    p[:shared] = np.arange(shared)
    return p


# ---------------------------------------------------------------------------
# the page table: the reference's properties (tests/test_paging.py) on the
# port's PageTable
# ---------------------------------------------------------------------------


@settings(deadline=None, max_examples=40)
@given(seed=st.integers(min_value=0, max_value=10_000),
       n_pages=st.integers(min_value=4, max_value=24),
       page_size=st.sampled_from([1, 2, 4]),
       n_ops=st.integers(min_value=5, max_value=60))
def test_page_table_invariants_under_random_ops(seed, n_pages, page_size,
                                                n_ops):
    """Random admit / register / release sequences keep every invariant;
    full release drains back to exactly capacity pages."""
    rng = np.random.default_rng(seed)
    n_slots = 4
    slot_pages = max(2, (n_pages - 1) // 2)
    pt = PageTable(n_pages, page_size, slot_pages)
    live = {}
    for _ in range(n_ops):
        op = rng.integers(0, 3)
        if op == 0:
            free = [i for i in range(n_slots) if i not in live]
            if not free:
                continue
            slot = int(rng.choice(free))
            p_len = int(rng.integers(1, slot_pages * page_size))
            shared = int(rng.integers(0, p_len + 1))
            total = min(p_len + int(rng.integers(1, 4)),
                        slot_pages * page_size)
            prompt = _prompt(rng, p_len, shared)
            before = pt.n_free
            got = pt.admit(slot, prompt, total)
            if got is None:
                assert pt.n_free == before      # backoff mutates nothing
            else:
                row, reused = got
                assert reused % page_size == 0 and reused < len(prompt)
                n_needed = pages_for(total, page_size)
                assert (row[:n_needed] != NULL_PAGE).all()
                assert (row[n_needed:] == NULL_PAGE).all()
                live[slot] = prompt
        elif op == 1 and live:
            slot = int(rng.choice(list(live)))
            pt.register_filled(slot, int(rng.integers(0,
                                                       len(live[slot]) + 1)))
        elif op == 2 and live:
            slot = int(rng.choice(list(live)))
            pt.release(slot)
            del live[slot]
        pt.check_invariants()
        assert pt.n_free + pt.n_used == pt.capacity
    for slot in list(live):
        pt.release(slot)
    pt.check_invariants()
    assert pt.n_free == pt.capacity and pt.n_used == 0
    assert (pt.ref == 0).all()


@settings(deadline=None, max_examples=25)
@given(seed=st.integers(min_value=0, max_value=10_000),
       page_size=st.sampled_from([2, 4]))
def test_page_table_never_double_allocates_live_page(seed, page_size):
    rng = np.random.default_rng(seed)
    pt = PageTable(n_pages=9, page_size=page_size, slot_pages=4)
    seen = set()
    slot = 0
    while True:
        tokens = int(rng.integers(1, 4 * page_size + 1))
        got = pt.admit(slot, _prompt(rng, max(1, tokens - 1)), tokens)
        if got is None:
            assert pages_for(tokens, page_size) > pt.n_free
            break
        row, reused = got
        assert reused == 0
        pages = {int(p) for p in row if p != NULL_PAGE}
        assert not (pages & seen), "live page handed out twice"
        seen |= pages
        slot += 1
    assert pt.alloc_backoffs == 1


def test_prefix_hit_maps_shared_pages_and_caps_at_last_token():
    pt = PageTable(n_pages=16, page_size=4, slot_pages=4)
    prompt = np.arange(12, dtype=np.int32)     # exactly 3 pages
    row0, reused0 = pt.admit(0, prompt, 14)
    assert reused0 == 0
    pt.register_filled(0, 12)
    row1, reused1 = pt.admit(1, prompt, 14)
    assert reused1 == 8                         # (12 - 1) // 4 pages
    assert row1[:2].tolist() == row0[:2].tolist() and row1[2] != row0[2]
    assert pt.ref[row0[0]] == 2 and pt.ref[row0[1]] == 2
    div = prompt.copy()
    div[5] = 99                                 # page 1 differs
    assert pt.admit(2, div, 14)[1] == 4
    pt.check_invariants()


def test_salt_partitions_prefix_hashes():
    pt = PageTable(n_pages=16, page_size=4, slot_pages=4)
    prompt = np.arange(12, dtype=np.int32)
    pt.admit(0, prompt, 14, salt=1)
    pt.register_filled(0, 12)
    assert pt.admit(1, prompt, 14, salt=1)[1] == 8
    assert pt.admit(2, prompt, 14, salt=2)[1] == 0
    pt.check_invariants()


def test_partial_pages_and_generated_tokens_never_register():
    pt = PageTable(n_pages=16, page_size=4, slot_pages=4)
    prompt = np.arange(6, dtype=np.int32)
    pt.admit(0, prompt, 10)
    pt.register_filled(0, 6)
    pt.register_filled(0, 10)
    assert len(pt._key2page) == 1
    assert pt.admit(1, prompt, 10)[1] == 4
    pt.check_invariants()


def test_released_registered_pages_park_cached_and_revive():
    pt = PageTable(n_pages=8, page_size=2, slot_pages=3)
    prompt = np.arange(5, dtype=np.int32)
    pt.admit(0, prompt, 6)
    pt.register_filled(0, 5)
    pt.release(0)
    assert pt.n_used == 0 and len(pt._cached) == 2
    assert pt.admit(1, prompt, 6)[1] == 4       # revived without prefill
    pt.release(1)
    pt.admit(2, _prompt(np.random.default_rng(0), 5), 6)
    pt.admit(3, np.asarray([7, 8, 9], np.int32), 6)   # reclaims LRU
    pt.check_invariants()


def test_admit_backoff_mutates_nothing_and_counts():
    pt = PageTable(n_pages=4, page_size=4, slot_pages=3)
    assert pt.admit(0, np.arange(8, dtype=np.int32), 12) is not None
    before = pt.n_free
    assert pt.admit(1, np.arange(9, 13, dtype=np.int32), 8) is None
    assert pt.alloc_backoffs == 1 and pt.n_free == before
    pt.release(0)
    assert pt.admit(1, np.arange(9, 13, dtype=np.int32), 8) is not None
    pt.check_invariants()


def test_fits_is_the_submit_time_guard():
    pt = PageTable(n_pages=6, page_size=4, slot_pages=4)
    assert pt.fits(16) and not pt.fits(17)
    assert not PageTable(n_pages=3, page_size=4, slot_pages=8).fits(12)


@pytest.mark.parametrize("kw", (dict(n_pages=1, page_size=4, slot_pages=2),
                                dict(n_pages=8, page_size=0, slot_pages=2),
                                dict(n_pages=8, page_size=4, slot_pages=0)))
def test_constructor_rejects_degenerate_pools(kw):
    with pytest.raises(ValueError):
        PageTable(**kw)


def test_double_admit_same_slot_raises():
    pt = PageTable(n_pages=8, page_size=2, slot_pages=2)
    pt.admit(0, np.arange(2, dtype=np.int32), 3)
    with pytest.raises(ValueError, match="already holds pages"):
        pt.admit(0, np.arange(2, dtype=np.int32), 3)


# ---------------------------------------------------------------------------
# the page table and the paged scheduler op for op against the reference
# ---------------------------------------------------------------------------


def _table_state(pt):
    return (pt.ref.tolist(), [pt.page_row(i).tolist() for i in range(4)],
            pt.reused_tokens_total, pt.alloc_backoffs, pt.peak_used,
            pt.n_free, pt.n_used, list(pt._free), list(pt._cached),
            sorted(pt._page2key.items()))


@pytest.mark.parametrize("seed", range(6))
def test_page_table_matches_reference_op_for_op(seed):
    """One seeded sequence of admits (shared prefixes, salts), prefill
    registrations and releases through both tables: equal results and
    equal state after every op."""
    tables = (rserving.PageTable(14, 2, 5), PageTable(14, 2, 5))
    rng = np.random.default_rng(seed)
    live = {}
    for _ in range(80):
        op = int(rng.integers(0, 3))
        if op == 0:
            free = [i for i in range(4) if i not in live]
            if not free:
                continue
            slot = int(rng.choice(free))
            p_len = int(rng.integers(1, 9))
            prompt = _prompt(rng, p_len, int(rng.integers(0, p_len + 1)))
            total = min(p_len + int(rng.integers(1, 3)), 10)
            salt = int(rng.integers(0, 2))
            got = [t.admit(slot, prompt, total, salt=salt) for t in tables]
            assert (got[0] is None) == (got[1] is None)
            if got[1] is not None:
                assert got[1][0].tolist() == got[0][0].tolist()
                assert got[1][1] == got[0][1]
                live[slot] = p_len
        elif op == 1 and live:
            slot = int(rng.choice(list(live)))
            pp = int(rng.integers(0, live[slot] + 1))
            for t in tables:
                t.register_filled(slot, pp)
        elif op == 2 and live:
            slot = int(rng.choice(list(live)))
            del live[slot]
            for t in tables:
                t.release(slot)
        assert _table_state(tables[1]) == _table_state(tables[0])
    tables[1].check_invariants()


def _drive(mod, trace, **kw):
    """A scheduler with a page table through ``trace`` with the model's
    tokens replaced by a function of the step: the admissions, prompt
    cursors and outputs it yields."""
    pt = mod.PageTable(5, 4, 4)   # one request at a time
    sch = mod.Scheduler(2, 16, 4, page_table=pt, **kw)
    for r in trace:
        sch.submit(r)
    log, step = [], 0
    while sch.has_work:
        filled = sch.admit()
        log.append((filled, [sch.slots[i].pp for i in filled],
                    pt.alloc_backoffs))
        if sch.all_decoding and kw.get("headroom"):
            tok, remaining, _ = sch.burst_state()
            m = np.minimum(remaining, 1 + step % 3)
            emitted = np.full((2, 4), -1, np.int64)
            for i in range(2):
                emitted[i, :m[i]] = step + np.arange(m[i])
            sch.commit_spec(emitted, m)
        else:
            sch.plan()
            sch.commit(np.full((2,), 7 + step, np.int32))
        step += 1
    return log, sch.outputs, pt.reused_tokens_total, pt.peak_used


@pytest.mark.parametrize("headroom", (0, 2))
def test_paged_scheduler_matches_reference(headroom):
    """Shared prefixes over a pool that backs off: both schedulers admit
    the same requests into the same slots with the same reused prompt
    cursors, and record the same outputs (speculative commits too)."""
    out = [_drive(mod, mod.make_trace(5, 300, seed=4, shared_prefix=5,
                                      prompt_lens=(3, 4), gen_lens=(3, 5)),
                  headroom=headroom)
           for mod in (rserving, serving)]
    assert out[1] == out[0]
    assert out[1][2] > 0 and out[1][0][-1][2] >= 1


def test_scheduler_spec_interface_matches_reference():
    """Held drafts: set, read back, dropped by a plain commit."""
    seen = []
    for mod in (rserving, serving):
        sch = mod.Scheduler(3, 16, 4)
        for r in mod.make_trace(2, 300, seed=1, prompt_lens=(2,)):
            sch.submit(r)
        sch.admit()
        sch.plan()
        sch.commit(np.asarray([5, 6, 0], np.int32))
        sch.set_spec_drafts(np.asarray([9, 8, 7], np.int32))
        held = sch.spec_drafts().tolist()
        sch.plan()
        sch.commit(np.asarray([1, 2, 0], np.int32))
        seen.append((held, sch.spec_drafts().tolist()))
    assert seen[1] == seen[0] == ([9, 8, -1], [-1, -1, -1])


def test_host_modules_import_neither_torch_nor_jax():
    for name in ("paging.py", "speculative.py", "scheduler.py"):
        tree = ast.parse((SRC / "serving" / name).read_text())
        roots = {a.name.split(".")[0] for node in ast.walk(tree)
                 if isinstance(node, ast.Import) for a in node.names}
        roots |= {node.module.split(".")[0] for node in ast.walk(tree)
                  if isinstance(node, ast.ImportFrom) and node.module}
        assert not roots & {"torch", "jax", "repro"}, (name, roots)


# ---------------------------------------------------------------------------
# the paged insert and gather
# ---------------------------------------------------------------------------


def _pool_case(seed):
    """A pool of 7 pages of 3 rows, 3 slots with page rows (slot 2 idle,
    all null), chunk C = 4 at ragged lengths."""
    rng = np.random.default_rng(seed)
    pool = rng.standard_normal((7, 3, 2, 4)).astype(np.float32)
    new = rng.standard_normal((3, 4, 2, 4)).astype(np.float32)
    pages = np.asarray([[3, 5, 1, 0], [2, 6, 4, 0], [0, 0, 0, 0]], np.int32)
    cur = np.asarray([1, 5, 0], np.int32)
    n_new = np.asarray([4, 3, 0], np.int32)
    return pool, new, pages, cur, n_new


@pytest.mark.parametrize("seed", (0, 1))
def test_paged_insert_and_view_match_reference(seed):
    """Exact on f32: every page but the null page equals the reference's
    after the insert, and so does the gathered view of every live slot at
    its valid positions.  The reference dumps dropped rows into the null
    page's first row; the port writes that row back unchanged."""
    pool, new, pages, cur, n_new = _pool_case(seed)
    ref = np.asarray(RA._insert_tokens_paged(
        jnp.asarray(pool), jnp.asarray(new), jnp.asarray(cur),
        jnp.asarray(n_new), jnp.asarray(pages)))
    out = TA._insert_tokens_paged(_t(pool).clone(), _t(new), _t(cur),
                                  _t(n_new), _t(pages)).numpy()
    np.testing.assert_array_equal(out[1:], ref[1:])
    np.testing.assert_array_equal(out[0], pool[0])
    np.testing.assert_array_equal(ref[0, 1:], pool[0, 1:])
    view = TA.paged_view(_t(out), _t(pages)).numpy()
    rview = np.asarray(RA.paged_view(jnp.asarray(ref), jnp.asarray(pages)))
    assert view.shape == rview.shape == (3, 12, 2, 4)
    for b in range(2):
        n = cur[b] + n_new[b]
        np.testing.assert_array_equal(view[b, :n], rview[b, :n])
        np.testing.assert_array_equal(view[b, cur[b]:n], new[b, :n_new[b]])


def test_paged_chunk_attention_equals_contiguous_and_reference():
    """``gqa_prefill_chunk`` on a paged pool against the same rows in a
    contiguous cache (the port) and against the reference's paged call."""
    rng = np.random.default_rng(3)
    acfg = dict(d_model=16, n_heads=4, n_kv_heads=2, head_dim=8)
    tcfg, rcfg = TA.AttnConfig(**acfg), RA.AttnConfig(**acfg)
    fp = RS.QuantPolicy(mode="fp")
    rp = RA.gqa_init(jax.random.PRNGKey(1), rcfg, fp)
    tp = torch.nn.ModuleDict({k: TS.dense_linear(_t(RS.dense_view(v)))
                              for k, v in rp.items()})
    pages = np.asarray([[4, 2, 6], [1, 5, 3]], np.int32)
    cur, n_new = np.asarray([2, 5], np.int32), np.asarray([3, 1], np.int32)
    x = rng.standard_normal((2, 3, 16)).astype(np.float32)
    pool = rng.standard_normal((7, 4, 2, 8)).astype(np.float32)
    cache = {"k": pool, "v": pool[::-1].copy()}
    r_out, _ = RA.gqa_prefill_chunk(
        rp, jnp.asarray(x), {k: jnp.asarray(v) for k, v in cache.items()},
        jnp.asarray(cur), jnp.asarray(n_new), rcfg,
        fp, pages=jnp.asarray(pages))
    t_out, _ = TA.gqa_prefill_chunk(
        tp, _t(x), {k: _t(v).clone() for k, v in cache.items()}, _t(cur),
        _t(n_new), tcfg, pages=_t(pages))
    contiguous = {k: TA.paged_view(_t(v), _t(pages)).clone()
                  for k, v in cache.items()}
    c_out, _ = TA.gqa_prefill_chunk(tp, _t(x), contiguous, _t(cur), _t(n_new),
                                    tcfg)
    for b in range(2):
        rows = slice(0, n_new[b])
        np.testing.assert_allclose(t_out[b, rows].numpy(),
                                   np.asarray(r_out)[b, rows], atol=1e-5,
                                   rtol=0)
        np.testing.assert_array_equal(t_out[b, rows].numpy(),
                                      c_out[b, rows].numpy())


# ---------------------------------------------------------------------------
# the paged model step and engine
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=("gemma3-1b", "llama7b-proxy"))
def served(request):
    arch = request.param
    rcfg, tcfg = RC.reduced(arch), TC.reduced(arch)
    rlm, tlm = RLM(rcfg), TLM(tcfg)
    raw = rlm.init(jax.random.PRNGKey(0))
    merged = merge_model(raw, rcfg.quant)
    return SimpleNamespace(
        arch=arch, rcfg=rcfg, tcfg=tcfg, rlm=rlm, tlm=tlm, raw=raw,
        merged=merged,
        tmerged=bridge.load_numpy_tree(numpy_tree(merged), tcfg, "cpu"))


def test_paged_step_ragged_matches_reference(served):
    """Two ragged steps (a chunk, then decode rows) on a paged cache with
    scattered page rows: logits within the port's step tolerance of the
    reference's paged ``step_ragged`` under ``jax.jit``, no mesh; the
    lengths advance alike and the port's page rows are untouched."""
    ps, n_pages = 4, 9
    pages = np.asarray([[5, 2, 7, 0], [1, 8, 3, 6]], np.int32)
    rng = np.random.default_rng(0)
    steps = [(rng.integers(4, served.rcfg.vocab, size=(2, 4)).astype(
        np.int32), np.asarray([4, 3], np.int32))]
    steps.append((steps[0][0][:, :1] + 1, np.asarray([1, 1], np.int32)))
    rcache = served.rlm.slot_state(ps, n_pages).init(2, 16,
                                                     dtype=jnp.float32)
    rcache["pages"] = jnp.asarray(pages)
    tcache = served.tlm.slot_state(ps, n_pages).init(
        2, 16, dtype=torch.float32, device="cpu")
    tcache["pages"].copy_(_t(pages))
    rstep = jax.jit(served.rlm.step_ragged)
    for toks, n_new in steps:
        r_logits, rcache = rstep(served.merged, rcache, jnp.asarray(toks),
                                 jnp.asarray(n_new))
        t_logits, _ = served.tlm.step_ragged(served.tmerged, tcache,
                                             _t(toks), _t(n_new))
        np.testing.assert_allclose(t_logits.numpy(), np.asarray(r_logits),
                                   atol=TOL, rtol=0)
    np.testing.assert_array_equal(tcache["len"].numpy(),
                                  np.asarray(rcache["len"]))
    np.testing.assert_array_equal(tcache["pages"].numpy(), pages)


def _serve(mod, lm, tree, trace, **kw):
    eng = mod.ContinuousEngine(lm, tree, **kw)
    for r in trace:
        eng.submit(r.prompt, r.max_new_tokens, r.eos_id, rid=r.rid)
    return eng, eng.run()


def _both(served, trace, **kw):
    """The reference's engine (no mesh) and the port's on ``trace``."""
    return (_serve(rserving, served.rlm, served.merged, trace, **kw),
            _serve(serving, served.tlm, served.tmerged, trace, **kw))


def test_paged_engine_matches_contiguous_and_reference(served):
    """A mixed trace with more requests than slots (eviction and refill,
    chunked prefill, bursts): the port's paged engine gives the port's
    contiguous engine's streams and the reference paged engine's, and its
    pool drains to empty."""
    trace = serving.make_trace(7, served.rcfg.vocab, seed=3,
                               prompt_lens=(3, 6, 11), gen_lens=(2, 9, 4))
    kw = dict(n_slots=3, max_len=24, prefill_chunk=4, decode_burst=4)
    _, cont = _serve(serving, served.tlm, served.tmerged, trace, **kw)
    (reng, ref), (eng, paged) = _both(served, trace, page_size=4, **kw)
    assert paged == cont == ref
    eng.page_table.check_invariants()
    assert eng.page_table.n_used == 0
    assert eng.page_table.peak_used == reng.page_table.peak_used


def test_prefix_reuse_prefills_shared_pages_once(served):
    """The reference's prefix trace (n_slots 1 serialises it): every
    request after the first reuses the shared 8-token prefix; reused
    tokens and backoffs equal the reference engine's, and the skipped
    chunks are model rows saved, with the contiguous engine's tokens."""
    trace = serving.make_trace(3, served.rcfg.vocab, seed=5, shared_prefix=8,
                               prompt_lens=(3,), gen_lens=(4,))
    kw = dict(n_slots=1, max_len=16, prefill_chunk=4, decode_burst=4)
    ec, cont = _serve(serving, served.tlm, served.tmerged, trace, **kw)
    (reng, ref), (eng, paged) = _both(served, trace, page_size=4, **kw)
    assert paged == cont == ref
    pt, rpt = eng.page_table, reng.page_table
    assert pt.reused_tokens_total == rpt.reused_tokens_total \
        == (len(trace) - 1) * 8
    assert pt.alloc_backoffs == rpt.alloc_backoffs
    assert eng.stats.busy_slot_steps < ec.stats.busy_slot_steps
    assert eng.stats.busy_slot_steps == reng.stats.busy_slot_steps
    pt.check_invariants()


def test_admission_backoff_completes_when_pages_free(served):
    """The reference's backoff trace: a pool of 3 usable pages holds one
    request at a time; the head backs off until pages free up, every
    request completes, and the counts equal the reference engine's."""
    trace = serving.make_trace(3, served.rcfg.vocab, seed=7,
                               prompt_lens=(4,), gen_lens=(4,))
    kw = dict(n_slots=2, max_len=16, prefill_chunk=4, decode_burst=4)
    _, cont = _serve(serving, served.tlm, served.tmerged, trace, **kw)
    (reng, ref), (eng, paged) = _both(served, trace, page_size=4, n_pages=4,
                                      **kw)
    assert paged == cont == ref
    assert eng.page_table.alloc_backoffs == reng.page_table.alloc_backoffs
    assert eng.page_table.alloc_backoffs >= 1
    eng.page_table.check_invariants()


def test_evict_never_frees_still_referenced_shared_page(served):
    """Cancelling the first of two slots sharing prefix pages drops its
    references but keeps the shared pages the survivor reads; the
    survivor's stream equals the port's static path served alone."""
    prompt = np.arange(10, 21, dtype=np.int32)     # 11 tokens: 2 full pages
    ref, _ = tserve.generate(served.tlm, served.tmerged, prompt[None], 4, 16,
                             device="cpu")
    eng = serving.ContinuousEngine(served.tlm, served.tmerged, n_slots=2,
                                   max_len=16, prefill_chunk=4,
                                   decode_burst=4, page_size=4)
    eng.submit(prompt, 5, rid=0)
    while eng.sched.slots[0] is None or eng.sched.slots[0].prefilling:
        eng.step_once()
    eng.submit(prompt, 4, rid=1)
    eng.step_once()
    pt = eng.page_table
    assert pt.reused_tokens_total == 8
    shared = [int(p) for p in pt.page_row(0)[:2]]
    assert [int(p) for p in pt.page_row(1)[:2]] == shared
    assert [int(p) for p in eng.cache["pages"][1, :2]] == shared
    free_before = pt.n_free
    assert eng.evict_slot(0) is not None
    assert all(pt.ref[p] == 1 for p in shared) and pt.n_free > free_before
    out = eng.run()
    assert out[1] == ref[0].tolist() and 0 not in out
    assert pt.n_used == 0
    pt.check_invariants()


def _noisy(raw, mag, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, x: x + mag * rng.standard_normal(x.shape).astype(
            x.dtype) if any(getattr(k, "key", None) == "ad" for k in path)
        else x, raw)


def test_paged_tenants_share_no_pages_and_match_contiguous(served):
    """Two tenants serving one prompt on a paged engine: the adapter id
    salts the prefix hashes, so the second tenant reuses none of the
    first's pages, and every stream equals the contiguous multi-tenant
    engine's and the reference paged engine's."""
    tcfg = served.tcfg

    def stores():
        port = lambda tree: bridge.load_numpy_tree(numpy_tree(tree), tcfg,
                                                   "cpu")
        rst = rserving.AdapterStore(served.raw, capacity=2)
        tst = serving.AdapterStore(port(served.raw), capacity=2)
        for name, mag, seed in (("alpha", 0.02, 1), ("beta", 0.03, 2)):
            tree = _noisy(served.raw, mag, seed)
            rst.register(name, tree)
            tst.register(name, port(tree))
        return rst, tst

    prompt = np.arange(10, 21, dtype=np.int32)
    outs = {}
    for kind, page_size in (("contiguous", 0), ("paged", 4),
                            ("reference", 4)):
        rst, tst = stores()
        mod, lm, st = ((rserving, served.rlm, rst) if kind == "reference"
                       else (serving, served.tlm, tst))
        eng = mod.ContinuousEngine(lm, st.base, n_slots=2, max_len=16,
                                   prefill_chunk=4, decode_burst=4,
                                   adapters=st, page_size=page_size)
        eng.submit(prompt, 5, rid=0, adapter_id="alpha")
        while eng.sched.slots[0] is None or eng.sched.slots[0].prefilling:
            eng.step_once()
        eng.submit(prompt, 4, rid=1, adapter_id="beta")
        eng.submit(prompt, 4, rid=2, adapter_id="alpha")
        eng.step_once()
        if page_size:
            assert eng.page_table.reused_tokens_total == 0  # beta: no hit
        outs[kind] = eng.run()
        if page_size:
            # alpha's second request hit alpha's registered pages
            assert eng.page_table.reused_tokens_total == 8
    assert outs["paged"] == outs["contiguous"] == outs["reference"]


def test_engine_paged_refusals_match_reference(served):
    """A request the pool can never cover fails at submit in both
    packages; within-pool requests pass; a one-page pool is refused."""
    for mod, lm, tree in ((rserving, served.rlm, served.merged),
                          (serving, served.tlm, served.tmerged)):
        eng = mod.ContinuousEngine(lm, tree, n_slots=2, max_len=16,
                                   page_size=4, n_pages=3)
        with pytest.raises(ValueError, match="page pool"):
            eng.submit(np.arange(4, 12, dtype=np.int32), 4)
        eng.submit(np.arange(4, 8, dtype=np.int32), 4)
        with pytest.raises(ValueError, match="n_pages >= 2"):
            mod.ContinuousEngine(lm, tree, n_slots=2, max_len=16,
                                 page_size=4, n_pages=1)


def test_serve_cli_paged_gives_the_contiguous_tokens():
    argv = ["--arch", "gemma3-1b", "--reduced", "--device", "cpu",
            "--engine", "continuous", "--requests", "3", "--slots", "2",
            "--prompt-len", "9", "--gen-len", "5", "--prefill-chunk", "4",
            "--verify"]
    plain = tserve.main(argv)
    paged = tserve.main(argv + ["--page-size", "4", "--n-pages", "7"])
    np.testing.assert_array_equal(paged["tokens"], plain["tokens"])
    assert paged["alloc_backoffs"] >= 1 and paged["page_size"] == 4
    assert paged["peak_pages_used"] <= 6
    for r in paged["merge_check"].values():
        assert r["rel"] <= paged["merge_bound_rel"]


def test_paged_engine_captures_within_budget(served):
    """Under a ``CompileGuard`` with a stand-in capture (the replay calls
    the step again): one ragged capture and the burst ladder, as on the
    contiguous layout; admissions write page rows and seeded lengths into
    the captured tensors in place, and the streams are the contiguous
    engine's."""
    from repro_torch.runtime import compile_guard as port_guard
    trace = serving.make_trace(6, served.rcfg.vocab, seed=9,
                               shared_prefix=8, prompt_lens=(3, 5),
                               gen_lens=(4, 7))
    kw = dict(n_slots=2, max_len=20, prefill_chunk=4, decode_burst=4)
    _, cont = _serve(serving, served.tlm, served.tmerged, trace, **kw)
    with port_guard.CompileGuard("paged") as guard:
        eng = serving.ContinuousEngine(served.tlm, served.tmerged,
                                       page_size=4, n_pages=9, **kw)
        for g in eng.graphs.values():
            g.capture = lambda fn, pool: fn
        eng._declare_budgets()
        ptrs = [t.data_ptr() for t in (*eng.cache["layers"].values(),
                                       eng.cache["len"], eng.cache["pages"])]
        for r in trace:
            eng.submit(r.prompt, r.max_new_tokens, r.eos_id, rid=r.rid)
        assert eng.run() == cont
        assert eng.page_table.reused_tokens_total > 0
        counts = guard.counts()
        assert counts["engine.ragged"] == (1, 1)
        assert 1 <= counts["engine.burst"][0] <= counts["engine.burst"][1]
        assert ptrs == [t.data_ptr() for t in (
            *eng.cache["layers"].values(), eng.cache["len"],
            eng.cache["pages"])]
        guard.check()
    del eng
