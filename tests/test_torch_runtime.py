"""The port's checkpoints and restartable train loop
(``repro_torch.checkpoint``, ``repro_torch.runtime``): the checkpoint and
loop tests of tests/test_substrate.py and tests/test_fault.py, on nested
dicts of tensors."""

import json
import os
import signal

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import (CheckpointManager, conform, is_complete,
                                    load_pytree, read_meta, save_pytree)
from repro_torch.checkpoint.manager import MANIFEST
from repro_torch.runtime import (PreemptionGuard, RestartableLoop,
                                 StragglerDetector)


def _tree():
    return {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "nested": {"b": (torch.randn(4, 5, generator=torch.Generator()
                                         .manual_seed(0)) * 1e-3)
                       .to(torch.bfloat16),
                       "q": torch.arange(8, dtype=torch.uint8),
                       "step": torch.tensor(7, dtype=torch.int32)}}


def _equal(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _equal(a[k], b[k])
        return
    assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(a, b)


def test_checkpoint_roundtrip_is_bit_exact_with_bf16(tmp_path):
    tree = _tree()
    save_pytree(tree, str(tmp_path / "ck"), meta={"arch": "x"})
    out = load_pytree(str(tmp_path / "ck"))
    _equal(out, tree)
    assert read_meta(str(tmp_path / "ck")) == {"arch": "x"}
    with open(tmp_path / "ck" / "treedef.json") as f:
        names = json.load(f)["dtypes"]
    assert "bfloat16" in names          # the dtype name is kept
    with np.load(tmp_path / "ck" / "leaves.npz") as z:
        assert any(z[k].dtype == np.uint16 for k in z.files)


def test_load_with_like_checks_structure_and_places_tensors(tmp_path):
    tree = _tree()
    save_pytree(tree, str(tmp_path / "ck"))
    _equal(load_pytree(str(tmp_path / "ck"), like=tree), tree)
    other = _tree()
    other["w"] = torch.zeros(3, 2)
    with pytest.raises(ValueError, match="the model has"):
        load_pytree(str(tmp_path / "ck"), like=other)
    with pytest.raises(ValueError, match="key paths differ"):
        conform({"w": tree["w"]}, tree, "here")


def test_manager_async_retention_resume(tmp_path):
    m = CheckpointManager(str(tmp_path), keep=2)
    for step in (10, 20, 30):
        m.save(step, {"x": torch.full((3,), float(step))})
    m.wait()
    assert m.all_steps() == [20, 30]  # retention dropped step 10
    assert m.latest_step() == 30
    out = m.restore(30, {"x": torch.zeros(3)})
    assert torch.equal(out["x"], torch.full((3,), 30.0))
    m.close()


def test_manager_snapshots_on_the_callers_thread(tmp_path):
    """The next step may overwrite a parameter in place while the write of
    the previous snapshot is still queued."""
    m = CheckpointManager(str(tmp_path))
    x = torch.ones(4)
    m.save(1, {"x": x})
    x.add_(5.0)
    m.wait()
    assert torch.equal(m.restore(1)["x"], torch.ones(4))
    m.close()


def test_manager_base_snapshot_immutable(tmp_path):
    m = CheckpointManager(str(tmp_path), async_write=False)
    m.save_base({"q": torch.ones(2)})
    m.save_base({"q": torch.zeros(2)})  # second call is a no-op
    out = m.restore_base({"q": torch.zeros(2)})
    assert torch.equal(out["q"], torch.ones(2))


def test_checkpoint_atomic_no_tmp_left(tmp_path):
    m = CheckpointManager(str(tmp_path), async_write=False)
    m.save(1, {"x": torch.ones(2)})
    assert not any(d.endswith(".tmp") for d in os.listdir(tmp_path))
    assert is_complete(m.step_dir(1))


def test_load_refuses_a_torn_dir(tmp_path):
    p = str(tmp_path / "ck")
    save_pytree(_tree(), p)
    os.remove(os.path.join(p, MANIFEST))   # simulate the torn write
    assert not is_complete(p)
    with pytest.raises(ValueError, match="torn/incomplete"):
        load_pytree(p)


def test_manager_skips_a_torn_step_and_reaps_it(tmp_path):
    m = CheckpointManager(str(tmp_path), keep=3, async_write=False)
    m.save(1, {"x": torch.ones(2)})
    m.save(2, {"x": torch.ones(2) * 2})
    torn = os.path.join(str(tmp_path), "step_00000003")
    os.makedirs(torn)                      # crashed writer: dir, no manifest
    with open(os.path.join(torn, "leaves.npz"), "wb") as f:
        f.write(b"partial")
    assert m.all_steps() == [1, 2] and m.latest_step() == 2
    assert torch.equal(m.restore(2)["x"], torch.ones(2) * 2)
    m.save(4, {"x": torch.ones(2)})        # a save reaps torn dirs
    assert not os.path.exists(torn)
    assert m.all_steps() == [1, 2, 4]


def test_writer_error_is_raised_on_the_next_save_and_wait(tmp_path):
    d = tmp_path / "ckpts"
    m = CheckpointManager(str(d))
    d.rmdir()
    d.write_text("not a directory")      # the writer thread cannot write
    m.save(1, {"x": torch.ones(2)})
    with pytest.raises(OSError):
        m.wait()
    with pytest.raises(OSError):
        m.save(2, {"x": torch.ones(2)})


def test_checkpoint_keys_must_be_strings(tmp_path):
    with pytest.raises(TypeError, match="keys must be str"):
        save_pytree({"x": torch.ones(2), 3: torch.ones(1)},
                    str(tmp_path / "ck"))


def test_straggler_detector():
    d = StragglerDetector(ratio=2.0, warmup=2)
    for _ in range(10):
        assert not d.check(1.0)
    assert d.check(5.0)          # clear outlier
    assert not d.check(1.0)      # ewma not polluted
    assert d.flagged == 1


def test_restartable_loop_resume_and_cadence():
    saves = []
    loop = RestartableLoop(total_steps=10, ckpt_every=4,
                           save_cb=lambda s: saves.append(s), start_step=2)
    seen = []
    end = loop.run(lambda s: seen.append(s) or {})
    assert seen == list(range(2, 10))
    assert end == 10
    assert saves == [4, 8, 10]


def test_restartable_loop_final_save_not_repeated_on_the_cadence():
    saves = []
    RestartableLoop(total_steps=8, ckpt_every=4,
                    save_cb=lambda s: saves.append(s)).run(lambda s: {})
    assert saves == [4, 8]


def test_preemption_guard_graceful():
    saves = []
    with PreemptionGuard() as guard:
        loop = RestartableLoop(total_steps=1000, ckpt_every=1000,
                               save_cb=lambda s: saves.append(s), guard=guard)

        def body(step):
            if step == 3:
                os.kill(os.getpid(), signal.SIGTERM)
            return {}

        end = loop.run(body)
    assert end == 4           # stopped right after the signal
    assert saves[-1] == 4     # final save happened
    assert signal.getsignal(signal.SIGTERM) is not guard._handler
