"""paddle_tpu_torch serving on the CPU: InferenceServer + Client over an
AnalysisPredictor loaded from a model directory the JAX package wrote.

Served answers are held to ``predictor.run`` of the same request alone
at atol 1e-5: a tolerance, not bit-equality, because the served batch
is padded to a bucket and so has another shape.
"""
import sys
import threading

import numpy as np
import pytest

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import serving
from paddle_tpu_torch.serving.admission import (
    PRIORITY_HIGH,
    PRIORITY_LOW,
    AdmissionQueue,
)
from test_torch_parity import bert_feed, cpu_predictor, save_jax_model

SERVE_TOL = dict(atol=1e-5, rtol=0)


@pytest.fixture(scope="module")
def predictor(tmp_path_factory):
    d = tmp_path_factory.mktemp("bert_small")
    save_jax_model(d, seed=8)
    return cpu_predictor(tfluid, d)


def _serve_concurrently(server, feeds):
    client = serving.Client(server)
    answers, errors = [None] * len(feeds), []

    def one(i):
        try:
            answers[i] = client.infer(feeds[i])
        except Exception as e:  # noqa: BLE001 — asserted below
            errors.append(repr(e))

    threads = [threading.Thread(target=one, args=(i,)) for i in range(len(feeds))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    return answers


@pytest.mark.parametrize("rows", [[1, 3, 5], [5, 1, 3, 3, 1, 5, 2, 8]])
def test_concurrent_requests_match_alone(predictor, rows):
    rng = np.random.RandomState(sum(rows))
    feeds = [bert_feed(rng, r) for r in rows]
    server = serving.InferenceServer(predictor, max_batch_size=8, batch_timeout_ms=20)
    try:
        assert server.warmup() == len(server.bucket_ladder)
        answers = _serve_concurrently(server, feeds)
    finally:
        server.stop(drain=True, timeout=60)
    for f, (out,) in zip(feeds, answers):
        alone, = predictor.run(f)
        assert out.shape == (f["src_ids"].shape[0], 16, 64)
        np.testing.assert_allclose(out, alone, **SERVE_TOL)
    m = server.metrics()
    assert m["requests"] == len(rows) and m["rows"] == sum(rows)
    assert m["warmup_runs"] == len(server.bucket_ladder) == 4  # 1, 2, 4, 8
    assert m["failed"] == m["shed"] == m["expired"] == 0


def test_stress_many_submitters(predictor):
    """More submitter threads than cores, with a short switch interval:
    every request gets its own rows back."""
    rng = np.random.RandomState(99)
    rows = [int(r) for r in rng.randint(1, 5, 24)]
    feeds = [bert_feed(rng, r) for r in rows]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    server = serving.InferenceServer(predictor, max_batch_size=8, batch_timeout_ms=2)
    try:
        answers = _serve_concurrently(server, feeds)
    finally:
        server.stop(drain=True, timeout=60)
        sys.setswitchinterval(old)
    for f, (out,) in zip(feeds, answers):
        alone, = predictor.run(f)
        np.testing.assert_allclose(out, alone, **SERVE_TOL)
    assert server.metrics()["rows"] == sum(rows)


def test_stop_drain_finishes_every_queued_request(predictor):
    rng = np.random.RandomState(5)
    feeds = [bert_feed(rng, r) for r in (2, 1, 4, 3, 1, 2, 5, 1)]
    server = serving.InferenceServer(predictor, max_batch_size=8, batch_timeout_ms=50)
    futures = [server.submit(f) for f in feeds]
    server.stop(drain=True, timeout=60)
    assert all(f.done() for f in futures)
    for f, fut in zip(feeds, futures):
        out, = fut.result()
        alone, = predictor.run(f)
        np.testing.assert_allclose(out, alone, **SERVE_TOL)
    with pytest.raises(serving.ServerClosed):
        server.submit(feeds[0])


def test_stop_without_drain_fails_queued_typed(predictor):
    server = serving.InferenceServer(predictor, max_batch_size=8, batch_timeout_ms=50)
    rng = np.random.RandomState(6)
    futures = [server.submit(bert_feed(rng, 1)) for _ in range(6)]
    server.stop(drain=False, timeout=60)
    for fut in futures:
        assert fut.done()
        try:
            out, = fut.result()
            assert out.shape == (1, 16, 64)
        except serving.ServerClosed:
            pass


def test_submit_validates_feeds(predictor):
    server = serving.InferenceServer(predictor, max_batch_size=4)
    rng = np.random.RandomState(7)
    try:
        with pytest.raises(ValueError, match="feed names"):
            server.submit({"src_ids": bert_feed(rng, 1)["src_ids"]})
        with pytest.raises(ValueError, match="exceeds max_batch_size"):
            server.submit(bert_feed(rng, 5))
        bad = bert_feed(rng, 2)
        bad["input_mask"] = bad["input_mask"][:, :8]
        with pytest.raises(ValueError, match="endpoint expects"):
            server.submit(bad)
        with pytest.raises(serving.DeadlineExceeded):
            server.submit(bert_feed(rng, 1), timeout_ms=0)
    finally:
        server.stop()


def test_bucket_policy_ladder_and_padding():
    p = serving.BucketPolicy(12)
    assert p.ladder == [1, 2, 4, 8, 12]
    assert [p.bucket_for(n) for n in (1, 3, 8, 9, 12)] == [1, 4, 8, 12, 12]
    feed = {"x": np.arange(6).reshape(3, 2)}
    padded = p.pad_feed(feed, 4)["x"]
    np.testing.assert_array_equal(padded[3], feed["x"][2])  # last real row repeated


class _Req:
    def __init__(self, priority, deadline=None):
        self.priority = priority
        self.deadline = deadline


def test_admission_sheds_lower_priority_for_higher():
    q = AdmissionQueue(capacity=2, adaptive=False)
    low, mid = _Req(PRIORITY_LOW), _Req(1)
    assert q.offer(low)[0] and q.offer(mid)[0]
    admitted, expired, shed, retry_ms = q.offer(_Req(PRIORITY_HIGH))
    assert admitted and shed == [low] and retry_ms >= 1.0
    admitted, _, shed, _ = q.offer(_Req(PRIORITY_LOW))
    assert not admitted and shed == []


def test_admission_is_deadline_ordered_within_a_class():
    q = AdmissionQueue(capacity=0, class_weights=None)
    late, soon, none = _Req(1, 1e12), _Req(1, 1e11), _Req(1)
    for r in (none, late, soon):
        q.offer(r)
    with q.cv:
        order = [q.pop_locked()[0] for _ in range(3)]
    assert order == [soon, late, none]
