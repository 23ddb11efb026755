"""The serving engine's multi-shard durability, port against the
reference, at tolerance 0: ``tests/test_persist.py``'s elastic N -> M
restore (a 4-shard engine's snapshot and a WAL record after it restored
onto 2 and 8 shards, and exactly onto 4) and ``reassign`` at 4 shards
with every bucket moved one shard on.  The reference runs in ONE
subprocess with 8 fake devices; the port replays each scenario on the CPU
and every stacked leaf, answer and ``stats_snapshot`` counter recorded is
equal."""

import pytest

pytest.register_assert_rewrite("torch_engine_scenarios")

import torch_engine_scenarios as es  # noqa: E402
from torch_parity import assert_same  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    with es.one_torch_thread():
        yield

MULTI_SHARD = [("elastic_restore", 4), ("reassign_preserves_answers", 4)]


@pytest.fixture(scope="module")
def reference_records(tmp_path_factory):
    return es.run_reference_subprocess(tmp_path_factory.mktemp("ref"),
                                       MULTI_SHARD)


@pytest.mark.parametrize("name,shards", MULTI_SHARD)
def test_engine_multi_shard_persist_case_equals_the_reference(
        name, shards, reference_records, tmp_path):
    rec = {}
    es.SCENARIOS[name](es.port(), str(tmp_path), rec, shards=shards)
    assert_same(reference_records[(name, shards)], rec,
                f"{name} at {shards} shards")
