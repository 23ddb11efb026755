"""The crash soak's worker hand-shake (``repro_torch.chaos.soak``), on the
CPU: a worker warms up (imports, and on the GPU the CUDA context and the
kernels), prints ``WARM`` and touches nothing on the disk until the parent
sends ``GO``; a worker whose parent closes its input instead ends without
a life.  A life's times: spawn to ``WARM``, ``GO`` to ``READY``, and spawn
to ``READY`` (a cold start when the worker was spawned just before)."""

import os

import pytest

pytest.register_assert_rewrite("torch_engine_scenarios")

import torch_engine_scenarios as es  # noqa: E402
from repro_torch.chaos import soak  # noqa: E402

ROWS, BATCH, EVERY = 256, 128, 2


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    with es.one_torch_thread():
        yield


def test_a_worker_waits_for_go_before_it_touches_its_state(tmp_path):
    workdir = str(tmp_path)
    proc = soak._spawn_worker(workdir, ROWS, BATCH, 0, EVERY, None, 1,
                              device="cpu")
    try:
        lines = []
        for line in proc.stdout:
            lines.append(line)
            if line.startswith("WARM"):
                break
        assert lines and lines[-1].startswith("WARM at="), lines
        assert os.listdir(workdir) == []   # warmed, nothing persisted yet
        proc.stdin.close()                 # the parent ended the soak
        assert proc.wait(timeout=60) == 0
        assert proc.stdout.read() == ""    # no BOOT: the life never ran
        assert os.listdir(workdir) == []
    finally:
        proc.kill()
        proc.stdout.close()


def test_a_life_reports_its_warm_up_and_a_cold_start(tmp_path):
    proc = soak._spawn_worker(str(tmp_path), ROWS, BATCH, 0, EVERY, None, 1,
                              device="cpu")
    life = soak._run_life(proc, 3)
    assert life["steps_seen"] == 3 and not life["armed_death"]
    assert life["exit"] == -9   # the parent's SIGKILL
    assert life["warm_s"] > 0 and life["start_s"] > 0
    # spawned just before the life: spawn to READY is the whole cold start,
    # its warm-up and GO to READY apart only by the WARM line's way here
    gap = life["ready_s"] - life["warm_s"] - life["start_s"]
    assert -0.05 < gap < 0.5, life
    assert 0 < life["engine_s"] < life["start_s"]
    assert life["restore_s"] is None   # the first life lays the base
