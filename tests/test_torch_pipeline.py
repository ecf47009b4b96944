"""The port's synthetic data pipeline against the reference's (``repro.data``).

Ports of the four pipeline tests of ``tests/test_substrates.py``, each also
held to the reference: the port's ``SyntheticLM`` is a numpy copy drawing
from ``Philox(key=seed, counter=[0, 0, step, shard])``, so every batch is
bitwise the reference's, and ``bigram_ceiling_loss`` equal.
"""
import pytest

pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.data import PipelineConfig as JaxPipelineConfig  # noqa: E402
from repro.data import SyntheticLM as JaxSyntheticLM  # noqa: E402
from repro_torch.data import PipelineConfig, SyntheticLM  # noqa: E402


def _pair(**kw):
    return SyntheticLM(PipelineConfig(**kw)), JaxSyntheticLM(JaxPipelineConfig(**kw))


def _same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_pipeline_determinism_and_shapes():
    pipe, ref = _pair(vocab_size=97, seq_len=16, global_batch=8, n_shards=4, seed=3)
    a = pipe.shard_batch(step=7, shard=2)
    b = pipe.shard_batch(step=7, shard=2)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    assert a["tokens"].shape == (2, 16)
    c = pipe.shard_batch(step=8, shard=2)
    assert not np.array_equal(a["tokens"], c["tokens"])  # steps differ
    d = pipe.shard_batch(step=7, shard=3)
    assert not np.array_equal(a["tokens"], d["tokens"])  # shards differ
    for step, shard in [(0, 0), (7, 2), (8, 2), (7, 3), (12345, 1)]:
        _same(pipe.shard_batch(step, shard), ref.shard_batch(step, shard))


def test_pipeline_replicated_workers_same_shard():
    """Paper policy: workers of a replica group read identical data."""
    pipe, ref = _pair(vocab_size=97, seq_len=8, global_batch=8, n_shards=2, replication=3)
    shards = [pipe.shard_of_worker(w) for w in range(6)]
    assert shards == [0, 1, 0, 1, 0, 1] == [ref.shard_of_worker(w) for w in range(6)]
    np.testing.assert_array_equal(
        pipe.worker_batch(0, 0)["tokens"], pipe.worker_batch(0, 2)["tokens"]
    )
    assert not np.array_equal(
        pipe.worker_batch(0, 0)["tokens"], pipe.worker_batch(0, 1)["tokens"]
    )
    for w in range(6):
        _same(pipe.worker_batch(3, w), ref.worker_batch(3, w))


def test_pipeline_global_batch_coverage():
    pipe, ref = _pair(vocab_size=31, seq_len=4, global_batch=12, n_shards=3)
    g = pipe.global_batch(0)
    assert g["tokens"].shape == (12, 4)
    assert g["labels"].shape == (12, 4)
    for step in (0, 1, 99):
        _same(pipe.global_batch(step), ref.global_batch(step))


@pytest.mark.parametrize("bigram_p", [1.0, 0.9])
def test_pipeline_is_learnable_structure(bigram_p):
    pipe, ref = _pair(vocab_size=64, seq_len=32, global_batch=4, bigram_p=bigram_p)
    b = pipe.global_batch(0)
    np.testing.assert_array_equal(pipe._perm, ref._perm)
    if bigram_p == 1.0:
        # with p=1 the chain is deterministic: labels follow the permutation
        np.testing.assert_array_equal(pipe._perm[b["tokens"]], b["labels"])
    assert pipe.bigram_ceiling_loss() < np.log(64)
    assert pipe.bigram_ceiling_loss() == ref.bigram_ceiling_loss()
    _same(b, ref.global_batch(0))
