# Copyright 2026 The TPU Accelerator Stack Authors.
# SPDX-License-Identifier: Apache-2.0
"""The port's checkpoint/resume (``utils/checkpointing.py``, torch-native)
held to the JAX package's contract: the cases of
``tests/test_checkpointing.py`` that are not orbax-specific, on the
port's module and CLI, plus state round trips of modules, optimizers and
ResNet's running statistics, and resumed runs equal to straight ones bit
for bit on the CPU."""

import json
import logging
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from container_engine_accelerators_tpu_torch.models import (  # noqa: E402
    resnet as tresnet,
    train_cli,
)
from container_engine_accelerators_tpu_torch.obs import (  # noqa: E402
    events as obs_events,
    metrics as obs_metrics,
)
from container_engine_accelerators_tpu_torch.utils import (  # noqa: E402
    checkpointing as ck,
)


def _state(w=0.0, n=0):
    return {"w": torch.arange(4.0) + w, "n": torch.tensor(n)}


def _corrupt(d, step):
    for root, _, files in os.walk(os.path.join(d, f"step_{step}")):
        for fn in files:
            with open(os.path.join(root, fn), "wb") as f:
                f.write(b"garbage")


def _result(capsys):
    lines = [l for l in capsys.readouterr().out.splitlines() if l.strip()]
    return json.loads(lines[-1])


def test_checkpoint_resume_smoke(tmp_path, capsys):
    d = str(tmp_path / "ckpt")
    base = ["--model", "mnist", "--batch-size", "8", "--device", "cpu",
            "--checkpoint-dir", d, "--checkpoint-every", "2"]
    assert train_cli.main(base + ["--steps", "2"]) == 0
    first = _result(capsys)
    assert first["start_step"] == 0 and first["steps_run"] == 2
    assert ck.latest_step(d) == 2
    assert train_cli.main(base + ["--steps", "3"]) == 0
    second = _result(capsys)
    assert second["start_step"] == 2 and second["steps_run"] == 1
    assert ck.latest_step(d) == 3


def test_train_cli_resumes_from_checkpoint(tmp_path, capsys):
    d = str(tmp_path / "ckpt")
    base = ["--model", "mnist", "--batch-size", "8", "--device", "cpu",
            "--checkpoint-dir", d, "--checkpoint-every", "2"]
    assert train_cli.main(base + ["--steps", "3"]) == 0
    assert _result(capsys)["steps_run"] == 3 and ck.latest_step(d) == 3
    assert train_cli.main(base + ["--steps", "5"]) == 0
    second = _result(capsys)
    assert second["start_step"] == 3 and second["steps_run"] == 2
    assert ck.latest_step(d) == 5
    # Already complete: no steps run.
    assert train_cli.main(base + ["--steps", "5"]) == 0
    assert _result(capsys)["steps_run"] == 0


def test_roundtrip_and_pruning(tmp_path):
    d = str(tmp_path / "ckpt")
    for step in (1, 2, 3, 4, 5):
        ck.save(d, step, _state(n=7))
    assert ck.list_steps(d) == [3, 4, 5]  # KEEP_LAST = 3
    assert ck.latest_step(d) == 5
    got = ck.restore(d, 5, _state())
    np.testing.assert_array_equal(got["w"].numpy(), np.arange(4.0))
    assert int(got["n"]) == 7


def test_empty_dir_has_no_steps(tmp_path):
    assert ck.list_steps(str(tmp_path / "missing")) == []
    assert ck.latest_step(str(tmp_path / "missing")) is None


def test_tmp_sibling_masks_incomplete_step(tmp_path):
    """A save in flight (or one that crashed) leaves
    ``step_N.tmp-<pid>-<ns>`` next to ``step_N``: that step is not
    complete, as orbax's tmp sibling masks it in the JAX package."""
    d = tmp_path / "ckpt"
    d.mkdir()
    (d / "step_3").mkdir()
    (d / "step_5").mkdir()
    (d / f"step_5{ck.TMP_MARK}1234-5").mkdir()
    (d / f"step_7{ck.TMP_MARK}1234-6").mkdir()
    assert ck.list_steps(str(d)) == [3]


def test_save_writes_a_sibling_then_renames(tmp_path, monkeypatch):
    """The state is written into the temporary sibling, and only the
    rename makes the step visible; an existing step is replaced."""
    d = str(tmp_path / "ckpt")
    seen = []
    real_rename = os.rename

    def rename(src, dst):
        seen.append((os.path.basename(src), os.path.basename(dst),
                     ck.list_steps(d)))
        real_rename(src, dst)

    monkeypatch.setattr(os, "rename", rename)
    ck.save(d, 1, _state(n=1))
    ck.save(d, 1, _state(n=2))
    assert [s[1] for s in seen] == ["step_1", "step_1"]
    assert seen[0][0].startswith("step_1" + ck.TMP_MARK)
    assert seen[0][2] == []  # invisible before the rename
    assert int(ck.restore(d, 1, _state())["n"]) == 2
    assert os.listdir(d) == ["step_1"]


def test_keep_last_zero_disables_pruning(tmp_path):
    d = str(tmp_path / "ckpt")
    for step in (1, 2, 3, 4):
        ck.save(d, step, _state(), keep_last=0)
    assert ck.list_steps(d) == [1, 2, 3, 4]


def test_keep_last_one_keeps_only_the_newest(tmp_path):
    d = str(tmp_path / "ckpt")
    for step in (1, 2, 3):
        ck.save(d, step, _state(), keep_last=1)
    assert ck.list_steps(d) == [3]


def test_save_never_prunes_a_step_mid_restore(tmp_path):
    d = str(tmp_path / "ckpt")
    for step in (1, 2, 3):
        ck.save(d, step, _state(), keep_last=0)
    key = (os.path.abspath(d), 1)
    with ck._protect_lock:
        ck._RESTORING.add(key)
    try:
        ck.save(d, 4, _state(), keep_last=2)
    finally:
        with ck._protect_lock:
            ck._RESTORING.discard(key)
    assert ck.list_steps(d) == [1, 3, 4]


def test_save_skips_prune_when_step_not_visible(tmp_path, monkeypatch):
    d = str(tmp_path / "ckpt")
    for step in (1, 2, 3):
        ck.save(d, step, _state(), keep_last=0)
    real = ck.list_steps
    monkeypatch.setattr(
        ck, "list_steps", lambda p: [s for s in real(p) if s != 4],
    )
    ck.save(d, 4, _state(), keep_last=1)
    monkeypatch.undo()
    assert ck.list_steps(d) == [1, 2, 3, 4]


def test_restore_latest_falls_back_through_quarantined_step(tmp_path):
    d = str(tmp_path / "ckpt")
    ck.save(d, 1, _state(1, 1))
    ck.save(d, 2, _state(2, 2))
    _corrupt(d, 2)
    reg = obs_metrics.Registry()
    ev = obs_events.EventStream("test", registry=reg)
    got, step = ck.restore_latest(d, _state(), events=ev)
    assert step == 1 and int(got["n"]) == 1
    assert os.path.isdir(os.path.join(d, "step_2.corrupt"))
    recs = ev.events(kind="checkpoint_fallback")
    assert len(recs) == 1
    assert recs[0]["step"] == 2
    assert recs[0]["quarantined"].endswith("step_2.corrupt")
    assert recs[0]["dur_s"] >= 0
    assert ck.list_steps(d) == [1]
    assert "tpu_checkpoint_fallbacks_total 1" in reg.render().decode()


def test_quarantine_suffixes_repeat_corruption(tmp_path):
    d = str(tmp_path / "ckpt")
    ck.save(d, 1, _state(), keep_last=0)
    assert ck.quarantine(d, 1).endswith("step_1.corrupt")
    ck.save(d, 1, _state(), keep_last=0)
    assert ck.quarantine(d, 1).endswith("step_1.corrupt.1")


def test_restore_latest_systematic_failure_stops_quarantining(tmp_path):
    d = str(tmp_path / "ckpt")
    for n in (1, 2, 3):
        ck.save(d, n, {"w": torch.arange(4.0) + n}, keep_last=0)
    for n in (2, 3):
        _corrupt(d, n)
    with pytest.raises(Exception):
        ck.restore_latest(d, {"w": torch.arange(4.0)})
    assert os.path.isdir(os.path.join(d, "step_3.corrupt"))
    assert os.path.isdir(os.path.join(d, "step_2"))
    assert ck.list_steps(d) == [1, 2]
    got, step = ck.restore_latest(d, {"w": torch.arange(4.0)},
                                  max_fallbacks=2)
    assert step == 1 and float(got["w"][0]) == 1.0


def test_restore_latest_empty_dir_returns_none(tmp_path):
    got, step = ck.restore_latest(str(tmp_path / "missing"), _state())
    assert got is None and step is None


def test_rmtree_failures_are_logged_not_swallowed(tmp_path, monkeypatch,
                                                  caplog):
    def fake_rmtree(path, onerror=None):
        onerror(None, path, (OSError, OSError("EBUSY"), None))

    monkeypatch.setattr(shutil, "rmtree", fake_rmtree)
    with caplog.at_level(logging.WARNING, logger="checkpointing"):
        assert ck._rmtree(str(tmp_path / "step_1")) is False
    assert "left partial state" in caplog.text


def test_mismatched_state_is_refused_not_half_loaded(tmp_path):
    d = str(tmp_path / "ckpt")
    ck.save(d, 1, {"w": torch.arange(4.0)})
    with pytest.raises(ValueError):
        ck.restore(d, 1, {"w": torch.arange(5.0)})
    with pytest.raises(ValueError):
        ck.restore(d, 1, {"v": torch.arange(4.0)})


def test_model_optimizer_and_running_stats_round_trip(tmp_path):
    """A (model, optimizer) state: parameters, SGD momentum buffers and
    ResNet's running statistics come back bit for bit, in place."""
    init_state, train_step = tresnet.make_train_step(
        lambda: tresnet.resnet18_ish(device="cpu"))
    state = init_state(seed=0)
    rng = np.random.default_rng(0)
    batch = {"images": rng.standard_normal((2, 32, 32, 3), dtype="float32"),
             "labels": rng.integers(0, 10, 2)}
    train_step(state, batch)
    d = str(tmp_path / "ckpt")
    ck.save(d, 1, state)
    fresh = init_state(seed=1)
    got = ck.restore(d, 1, fresh)
    assert got[0] is fresh[0] and got[1] is fresh[1]
    for (name, a), (_, b) in zip(state[0].state_dict().items(),
                                 fresh[0].state_dict().items()):
        assert torch.equal(a, b), name
    assert any(name.endswith(".var") for name in fresh[0].state_dict())
    for pa, pb in zip(state[0].parameters(), fresh[0].parameters()):
        assert torch.equal(state[1].state[pa]["momentum_buffer"],
                           fresh[1].state[pb]["momentum_buffer"])
    # The next step is the same in both.
    _, la = train_step(state, batch)
    _, lb = train_step(fresh, batch)
    assert la.item() == lb.item()


TINY = {
    "mnist": ["--batch-size", "8"],
    "resnet": ["--image-size", "32", "--batch-size", "4"],
    "bert": ["--seq-len", "32", "--d-model", "64", "--n-heads", "4",
             "--vocab-size", "128"],
    "transformer": ["--seq-len", "32", "--d-model", "64", "--n-heads", "4",
                    "--vocab-size", "128", "--n-experts", "4"],
}


def _final_state(d, steps):
    return torch.load(os.path.join(d, f"step_{steps}", ck.STATE_FILE),
                      weights_only=True)


def _assert_equal_states(a, b, path=""):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            _assert_equal_states(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_equal_states(x, y, f"{path}[{i}]")
    elif torch.is_tensor(a):
        assert torch.equal(a, b), path
    else:
        assert a == b, path


@pytest.mark.parametrize("model", sorted(TINY))
def test_resume_after_a_preemption_equals_the_straight_run(model, tmp_path,
                                                           capsys):
    """A run preempted at train.step hit 3 (checkpoints every 2 steps)
    restarts once from step 2 and ends with the straight run's loss,
    parameters, optimizer state and running statistics, bit for bit."""
    plan = tmp_path / "plan.json"
    plan.write_text(json.dumps({"faults": [
        {"kind": "preemption", "site": "train.step", "at": 3}]}))
    common = ["--model", model, "--steps", "5", "--device", "cpu",
              "--checkpoint-every", "2", *TINY[model]]
    straight, faulted = str(tmp_path / "a"), str(tmp_path / "b")
    assert train_cli.main(common + ["--checkpoint-dir", straight]) == 0
    want = _result(capsys)
    assert train_cli.main(common + [
        "--checkpoint-dir", faulted, "--max-restarts", "1",
        "--restart-backoff-s", "0.001", "--fault-plan", str(plan)]) == 0
    got = _result(capsys)
    assert got["restarts"] == 1 and got["start_step"] == 2
    assert got["loss"] == want["loss"]
    _assert_equal_states(_final_state(faulted, 5), _final_state(straight, 5))


def test_corrupt_newest_step_is_quarantined_and_resume_falls_back(
        tmp_path, capsys):
    d = str(tmp_path / "ckpt")
    ev = str(tmp_path / "ev.jsonl")
    base = ["--model", "mnist", "--batch-size", "8", "--device", "cpu",
            "--checkpoint-dir", d, "--checkpoint-every", "1",
            "--event-log", ev]
    assert train_cli.main(base + ["--steps", "4"]) == 0
    capsys.readouterr()
    _corrupt(d, 4)
    assert train_cli.main(base + ["--steps", "6"]) == 0
    res = _result(capsys)
    assert res["start_step"] == 3 and res["steps_run"] == 3
    assert os.path.isdir(os.path.join(d, "step_4.corrupt"))
    with open(ev) as f:
        recs = [json.loads(line) for line in f]
    fallbacks = [r for r in recs if r["kind"] == "checkpoint_fallback"]
    assert len(fallbacks) == 1 and fallbacks[0]["step"] == 4
    assert "goodput" in res
