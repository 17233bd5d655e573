"""The port's data stream (``repro_torch.data``, its own copy of the pure
numpy ``repro.data.pipeline``) against the reference: bit-identical
batches for every task, after ``skip_to``, per host and with a bounded
dataset that wraps."""

import numpy as np
import pytest

from repro.data import DataConfig as RDataConfig
from repro.data import InstructionStream as RStream
from repro.data import make_stream as ref_stream
from repro.data.pipeline import TASKS as REF_TASKS
from repro_torch.data import DataConfig, InstructionStream, make_stream
from repro_torch.data.pipeline import TASKS, _answer


def _same(port, ref, steps=3):
    for _ in range(steps):
        (t, lab), (rt, rl) = port.next_batch(), ref.next_batch()
        assert t.dtype == rt.dtype and lab.dtype == rl.dtype
        np.testing.assert_array_equal(t, rt)
        np.testing.assert_array_equal(lab, rl)


def test_port_has_the_reference_tasks():
    assert TASKS == REF_TASKS


@pytest.mark.parametrize("task", TASKS)
@pytest.mark.parametrize("seq_len", (32, 256))
def test_batches_bit_identical_to_reference(task, seq_len):
    kw = dict(vocab=512, seq_len=seq_len, global_batch=4, seed=3)
    _same(make_stream(task, **kw), ref_stream(task, **kw))


@pytest.mark.parametrize("task", TASKS)
def test_skip_to_bit_identical_to_reference(task):
    kw = dict(vocab=32000, seq_len=64, global_batch=2)
    port, ref = make_stream(task, **kw), ref_stream(task, **kw)
    port.skip_to(7)
    ref.skip_to(7)
    _same(port, ref, steps=2)
    # and to the port's own uninterrupted stream
    whole = make_stream(task, **kw)
    for _ in range(7):
        whole.next_batch()
    again = make_stream(task, **kw)
    again.skip_to(7)
    _same(again, whole, steps=1)


@pytest.mark.parametrize("host_id", (0, 1, 2, 3))
def test_host_shards_bit_identical_to_reference(host_id):
    kw = dict(dataset="longform", vocab=300, seq_len=48, global_batch=8,
              host_id=host_id, n_hosts=4)
    _same(InstructionStream(DataConfig(**kw)), RStream(RDataConfig(**kw)))


def test_host_shards_tile_the_global_batch():
    kw = dict(vocab=64, seq_len=32, global_batch=4)
    full, _ = InstructionStream(DataConfig(**kw)).next_batch()
    parts = [InstructionStream(DataConfig(**kw, host_id=h, n_hosts=2))
             .next_batch()[0] for h in (0, 1)]
    np.testing.assert_array_equal(np.concatenate(parts), full)


def test_bounded_dataset_wraps_as_reference():
    kw = dict(dataset="chip2", vocab=128, seq_len=32, global_batch=4,
              n_examples=6, seed=1)
    port, ref = InstructionStream(DataConfig(**kw)), RStream(RDataConfig(**kw))
    _same(port, ref, steps=4)


def test_labels_supervise_answers_only():
    toks, labs = make_stream("selfinst", vocab=64, seq_len=64,
                             global_batch=2).next_batch()
    assert (labs >= -1).all() and (labs < 64).all()
    assert (labs >= 0).any() and (labs == -1).any()


def test_answers_follow_each_task_stride():
    rng = np.random.default_rng(0)
    p = rng.integers(4, 64, size=8)
    for task in TASKS:
        a = _answer(task, p, 64)
        assert a.ndim == 1 and len(a) >= len(p)


def test_unknown_task_and_uneven_hosts_refused():
    with pytest.raises(AssertionError):
        make_stream("wikitext")
    with pytest.raises(AssertionError):
        InstructionStream(DataConfig(global_batch=3, n_hosts=2))
