"""``paddle_tpu_torch.serving.wire`` in one process on the CPU: the codec
against the JAX package's (byte-equal frames for the same meta and
arrays, each package decoding the other's), the codec's bounded-read
refusals, the W3C ``traceparent`` helpers, the HTTP transport with
``ServingProcess`` and ``RemoteClient`` (typed errors, deadlines and
overload as end states, the admin surfaces with ``hand_kernels`` in
``/statusz``, the single-process span chain), a JAX-exported MLP served
by the port and answered to both packages' clients, and the two tools
copied from ``tools/`` (``fleet_top``, ``autotune_ladder``).

Tolerances: the served MLP within 1e-5 of the JAX package's predictor on
the same rows (fp32 matmuls of 16 and 32 terms; measured ~1e-7); a stub
endpoint's row sums within rtol 1e-6.  The child-process fleet is
``tests/test_torch_wire_fleet.py``.
"""
import io
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from paddle_tpu_torch import kernels, monitor
from paddle_tpu_torch.inference import AnalysisConfig, create_paddle_predictor
from paddle_tpu_torch.serving import wire
from paddle_tpu_torch.serving.errors import (
    BackendUnavailable,
    DeadlineExceeded,
    ServerClosed,
    ServerOverloaded,
    ServingError,
    WireProtocolError,
)
from paddle_tpu_torch.serving.server import InferenceServer
from paddle_tpu_torch.serving.wire import codec

IN_DIM, OUT_DIM = 16, 4
MLP_TOL = 1e-5

_DTYPES = ["bool", "int8", "uint8", "int16", "int32", "int64",
           "float16", "float32", "float64", "complex64"]
_SHAPES = [(), (1,), (7,), (0,), (3, 4), (2, 0, 5), (2, 3, 4, 2)]


def _arbitrary_arrays(seed):
    """The JAX package's round-trip arrays: every dtype and shape, C-order,
    F-order and strided views."""
    rng = np.random.RandomState(seed)
    out = []
    for i, (dt, shape) in enumerate((d, s) for d in _DTYPES for s in _SHAPES):
        arr = (rng.uniform(-100, 100, shape) * 3).astype(dt)
        mode = i % 3
        if mode == 1 and arr.ndim >= 2:
            arr = np.asfortranarray(arr)
        elif mode == 2 and arr.ndim >= 1 and arr.shape[0] >= 4:
            arr = arr[::2]
        out.append(arr)
    return out


def _rows(n, seed=0):
    return np.random.RandomState(seed).uniform(-1, 1, (n, IN_DIM)).astype("float32")


# ---------------------------------------------------------------------------
# codec: byte-equal to the JAX package's, both directions
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1])
def test_codec_frames_byte_equal_to_the_jax_package(seed):
    from paddle_tpu.serving.wire import codec as jcodec

    arrays = _arbitrary_arrays(seed)
    meta = {"feed_names": ["a%d" % i for i in range(len(arrays))],
            "nested": {"k": [1, 2.5, "uniçode", None, True]}, "timeout_ms": 12.5}
    body = codec.encode_message(meta, arrays)
    assert body == jcodec.encode_message(meta, arrays)
    for decode in (codec.decode_message, jcodec.decode_message):
        rmeta, rarrays = decode(body)
        assert rmeta == meta and len(rarrays) == len(arrays)
        for a, b in zip(arrays, rarrays):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
    # an empty message and a meta-only one too
    for m, arrs in (({}, []), ({"ok": True, "draining": True}, [])):
        assert codec.encode_message(m, arrs) == jcodec.encode_message(m, arrs)
    assert (codec.MAGIC, codec.DEFAULT_MAX_FRAME_BYTES, codec.DEFAULT_MAX_FRAMES) == (
        jcodec.MAGIC, jcodec.DEFAULT_MAX_FRAME_BYTES, jcodec.DEFAULT_MAX_FRAMES)


def test_codec_rejects_truncation_everywhere():
    body = codec.encode_message({"feed_names": ["x"]}, [np.arange(300, dtype=np.float64)])
    for cut in list(range(0, len(body), 7)) + [len(body) - 1]:
        with pytest.raises(WireProtocolError):
            codec.decode_message(body[:cut])


def test_codec_rejects_oversized_and_malformed_frames():
    body = codec.encode_message({}, [np.zeros(1000, dtype=np.float64)])
    with pytest.raises(WireProtocolError, match="oversized"):
        codec.decode_message(body, max_frame_bytes=64)
    with pytest.raises(WireProtocolError, match="magic"):
        codec.decode_message(b"NOPE" + body[4:])
    with pytest.raises(WireProtocolError, match="kind"):
        codec.decode_message(codec.MAGIC + b"Z" + b"\x00" * 4)
    with pytest.raises(WireProtocolError, match="trailing"):
        codec.decode_message(body + b"x")
    bad = io.BytesIO()
    bad.write(codec.MAGIC)
    bad.write(codec._HEADER.pack(b"J", 2))
    bad.write(b"{}")
    bad.write(codec._HEADER.pack(b"A", 4))
    bad.write(b"junk")
    bad.write(codec._HEADER.pack(b"E", 0))
    with pytest.raises(WireProtocolError, match="array"):
        codec.decode_message(bad.getvalue())
    loop = io.BytesIO()
    loop.write(codec.MAGIC)
    loop.write(codec._HEADER.pack(b"J", 2))
    loop.write(b"{}")
    for _ in range(10):
        loop.write(codec._HEADER.pack(b"A", 0))
    with pytest.raises(WireProtocolError):
        codec.decode_message(loop.getvalue(), max_frames=5)
    # a meta frame that is not a JSON object, and a second meta frame
    for payloads in ([b"[1]"], [b"{}", b"{}"]):
        m = io.BytesIO()
        m.write(codec.MAGIC)
        for p in payloads:
            m.write(codec._HEADER.pack(b"J", len(p)))
            m.write(p)
        m.write(codec._HEADER.pack(b"E", 0))
        with pytest.raises(WireProtocolError, match="meta"):
            codec.decode_message(m.getvalue())


def test_codec_refuses_object_dtype():
    with pytest.raises(WireProtocolError):
        codec.encode_message({}, [np.array([{"a": 1}], dtype=object)])


def test_traceparent_roundtrip_malformed_and_equal_to_the_jax_package():
    from paddle_tpu.serving.wire import codec as jcodec

    tid, sid = monitor.new_trace_id(), monitor.new_span_id()
    hdr = codec.format_traceparent(tid, sid)
    assert hdr == jcodec.format_traceparent(tid, sid)
    assert codec.parse_traceparent(hdr) == jcodec.parse_traceparent(hdr) == (tid, sid)
    for bad in (None, "", "garbage", "00-zz-yy-01",
                "00-" + "0" * 32 + "-" + sid + "-01",
                "00-" + tid.rjust(32, "0") + "-" + "0" * 16 + "-01"):
        assert codec.parse_traceparent(bad) is None


# ---------------------------------------------------------------------------
# transport + ServingProcess over a stub predictor
# ---------------------------------------------------------------------------
class StubPredictor:
    def __init__(self, delay_s=0.0):
        self.delay_s = delay_s

    def get_input_names(self):
        return ["x"]

    def get_output_names(self):
        return ["y"]

    def input_specs(self):
        return {"x": ((IN_DIM,), np.dtype("float32"))}

    def jit_cache_stats(self):
        return {"entries": 0, "hits": 0, "misses": 0}

    def run_padded(self, feed, n_valid=None):
        if self.delay_s:
            time.sleep(self.delay_s)
        return [np.asarray(feed["x"][:n_valid]).sum(axis=1, keepdims=True)]


def _stub_wire_server(name, delay_s=0.0, **kw):
    srv = InferenceServer(StubPredictor(delay_s=delay_s), max_batch_size=8,
                          batch_timeout_ms=1, name=name, **kw)
    sp = wire.ServingProcess(srv)
    sp.start()
    return sp


def test_remote_client_roundtrip_and_typed_errors():
    sp = _stub_wire_server("t-rc")
    try:
        cli = wire.RemoteClient(sp.address)
        x = _rows(3, seed=1)
        out, = cli.infer({"x": x})
        np.testing.assert_allclose(out, x.sum(axis=1, keepdims=True), rtol=1e-6)
        assert set(cli.infer_named({"x": x})) == {"y"}
        outs = cli.infer_many([{"x": x}, {"x": x[:1]}])
        assert [o[0].shape[0] for o in outs] == [3, 1]
        out2, = cli.infer([x])
        np.testing.assert_array_equal(out2, out)
        with pytest.raises(ValueError):
            cli.infer({"nope": x})
        with pytest.raises(ValueError):
            cli.infer({"x": _rows(999)})
        with pytest.raises(ServingError, match="does not stream"):
            cli.infer_stream({"x": x})
        h = cli.healthz()
        assert h["ok"] and h["input_names"] == ["x"] and h["precision_dtypes"] == ["fp32"]
    finally:
        sp.stop()
    with pytest.raises((BackendUnavailable, ServerClosed)):
        cli.infer({"x": _rows(1)})
    cli.close()


def test_wire_deadline_and_overload_are_end_states():
    sp = _stub_wire_server("t-slow", delay_s=0.3, queue_capacity=1)
    cli = wire.RemoteClient(sp.address)
    try:
        with pytest.raises(DeadlineExceeded):
            cli.infer({"x": _rows(1)}, timeout_ms=30)
        outcomes = []
        lock = threading.Lock()

        def one():
            try:
                cli.infer({"x": _rows(1)}, timeout_ms=5000)
                res = "ok"
            except ServerOverloaded as e:
                res = "overload" if e.retry_after_ms is not None else "overload-no-hint"
            except DeadlineExceeded:
                res = "deadline"
            with lock:
                outcomes.append(res)

        threads = [threading.Thread(target=one, daemon=True) for _ in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        assert "overload" in outcomes and "overload-no-hint" not in outcomes, outcomes
    finally:
        cli.close()
        sp.stop(drain=False)


def test_wire_admin_surfaces_and_hand_kernels_in_statusz():
    sp = _stub_wire_server("t-admin")
    try:
        host, port = sp.address
        base = "http://%s:%d" % (host, port)
        h = json.load(urllib.request.urlopen(base + "/healthz", timeout=10))
        assert h["ok"] and h["live_replicas"] == 1 and h["pid"] > 0
        text = urllib.request.urlopen(base + "/metrics", timeout=10).read().decode()
        assert "wire_requests_total" in text
        st = json.load(urllib.request.urlopen(base + "/statusz", timeout=10))
        assert st["server"] == "t-admin"
        # the port's addition: this process's hand-kernel tally by dtype
        assert st["hand_kernels"] == json.loads(json.dumps(kernels.launch_counts_by_dtype()))
        assert "requests" in json.load(urllib.request.urlopen(base + "/tracez", timeout=10))
        assert "objectives" in json.load(urllib.request.urlopen(base + "/sloz", timeout=10))
        assert "events" in json.load(urllib.request.urlopen(base + "/eventz", timeout=10))
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(base + "/nope", timeout=10)
        cli = wire.RemoteClient(sp.address)
        assert cli.statusz()["hand_kernels"] == st["hand_kernels"]
        assert "wire_requests_total" in cli.metrics_text()
        cli.close()
    finally:
        sp.stop()


def test_wire_single_process_trace_chain():
    """client span -> wire/request -> wire/server_request (remote parent
    from traceparent) -> queue_wait, one trace id, one record."""
    sp = _stub_wire_server("t-trace1")
    cli = wire.RemoteClient(sp.address)
    fr = monitor.flight_recorder(slow_ms=0.0)
    try:
        cli.infer({"x": _rows(2, seed=5)})
        tid = cli.last_trace_id
        rec = fr.get_record(tid)
        assert rec is not None
        names = [s["name"] for s in rec["spans"]]
        assert names.count("serving/queue_wait") == 1
        by_name = {s["name"]: s for s in rec["spans"]}
        ci, wr = by_name["serving/client_infer"], by_name["wire/request"]
        ws, qw = by_name["wire/server_request"], by_name["serving/queue_wait"]
        assert wr["parent"] == ci["id"] and ws["parent"] == wr["id"] and qw["parent"] == ws["id"]
        for s in (ci, wr, ws, qw):
            assert s["trace_ids"] == [tid]
        tree = [r["tree"] for r in sp.server.tracez()["requests"] if r["trace_id"] == tid][0]
        assert "serving/client_infer" in {n["name"] for n in tree}
    finally:
        fr.close()
        cli.close()
        sp.stop()


def test_warmup_then_infer_on_one_keepalive_connection():
    """Control POSTs drain their bodies: the next infer on the same pooled
    connection still parses."""
    sp = _stub_wire_server("t-ka")
    cli = wire.RemoteClient(sp.address)
    try:
        passes = cli.warmup()
        assert passes == len(sp.server.bucket_ladder)  # one pass a rung: a stub replica
        out, = cli.infer({"x": _rows(2, seed=3)})
        assert out.shape == (2, 1)
        assert cli.warmup() == 0  # every rung already warm
        out, = cli.infer({"x": _rows(1, seed=4)})
        assert out.shape == (1, 1)
    finally:
        cli.close()
        sp.stop()


def test_in_band_errors_map_to_the_jax_packages_types():
    """The error names a port server writes are the names the JAX
    package's client maps back (one error vocabulary across packages)."""
    from paddle_tpu.serving.wire import client as jclient
    from paddle_tpu_torch.serving.wire import client as pclient

    assert set(pclient._ERROR_TYPES) == set(jclient._ERROR_TYPES)
    for name in pclient._ERROR_TYPES:
        with pytest.raises(Exception) as got:
            pclient.raise_in_band_error({"error": name, "message": "m", "retry_after_ms": 5})
        assert type(got.value).__name__ == name


# ---------------------------------------------------------------------------
# a JAX-exported model served by the port, answered to both packages
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def jax_mlp_dir(tmp_path_factory):
    import paddle_tpu as jfluid
    from paddle_tpu import framework as jframework

    d = str(tmp_path_factory.mktemp("wire") / "mlp")
    prog, startup = jframework.Program(), jframework.Program()
    prog.random_seed = startup.random_seed = 7
    with jframework.program_guard(prog, startup):
        x = jfluid.layers.data("x", [IN_DIM])
        h = jfluid.layers.fc(x, 32, act="relu")
        pred = jfluid.layers.fc(h, OUT_DIM, act="softmax")
    exe = jfluid.Executor(jfluid.CPUPlace())
    with jfluid.scope_guard(jfluid.Scope()):
        exe.run(startup)
        jfluid.save_inference_model(d, ["x"], [pred], exe, prog)
    return d


def _port_predictor(d):
    cfg = AnalysisConfig(d)
    cfg.disable_gpu()
    return create_paddle_predictor(cfg)


def test_jax_export_served_by_the_port_answers_both_packages(jax_mlp_dir):
    from paddle_tpu import inference as jinf
    from paddle_tpu.serving import wire as jwire

    jpred = jinf.create_paddle_predictor(jinf.AnalysisConfig(jax_mlp_dir))
    srv = InferenceServer(_port_predictor(jax_mlp_dir), max_batch_size=8, batch_timeout_ms=2,
                          name="t-jaxmlp")
    srv.warmup()
    sp = wire.ServingProcess(srv)
    sp.start()
    ours, theirs = wire.RemoteClient(sp.address), jwire.RemoteClient(sp.address)
    try:
        for n, seed in ((1, 11), (3, 12), (8, 13)):
            x = _rows(n, seed)
            want, = jpred.run({"x": x})
            want = np.asarray(want)
            for cli in (ours, theirs):
                got, = cli.infer({"x": x}, timeout_ms=30000)
                assert got.shape == (n, OUT_DIM)
                np.testing.assert_allclose(got, want, rtol=0, atol=MLP_TOL)
            named = theirs.infer_named({"x": x})
            assert list(named) == list(sp.healthz()["output_names"])
        # the JAX client's typed errors from the port's server
        from paddle_tpu.serving.errors import ServingError as JServingError

        with pytest.raises(ValueError):
            theirs.infer({"x": _rows(9)})
        with pytest.raises(JServingError, match="does not stream"):
            theirs.infer_stream({"x": _rows(1)})
        assert srv.metrics()["recompiles"] == 0
    finally:
        ours.close()
        theirs.close()
        sp.stop()


def test_port_client_against_the_jax_packages_server(jax_mlp_dir):
    from paddle_tpu import inference as jinf
    from paddle_tpu.serving import wire as jwire
    from paddle_tpu.serving.server import InferenceServer as JServer

    jpred = jinf.create_paddle_predictor(jinf.AnalysisConfig(jax_mlp_dir))
    jsrv = JServer(jpred, max_batch_size=4, batch_timeout_ms=2, name="t-jaxsrv")
    jsp = jwire.ServingProcess(jsrv)
    jsp.start()
    cli = wire.RemoteClient(jsp.address)
    try:
        x = _rows(3, 21)
        want, = jpred.run({"x": x})
        got, = cli.infer({"x": x}, timeout_ms=60000)
        np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=MLP_TOL)
        with pytest.raises(ValueError):
            cli.infer({"x": _rows(5)})  # the JAX server's in-band ValueError
    finally:
        cli.close()
        jsp.stop()


# ---------------------------------------------------------------------------
# the tools copied into paddle_tpu_torch/tools/
# ---------------------------------------------------------------------------
def test_fleet_top_once_renders_a_live_fleet():
    import sys

    from paddle_tpu_torch.monitor import slo as slo_mod
    from paddle_tpu_torch.tools import fleet_top

    sps = [_stub_wire_server("t-top-%d" % i) for i in range(2)]
    fleet = wire.FleetBalancer([sp.address for sp in sps], name="t-topfleet",
                               health_interval_s=0.2, admin_port=0, scrape_interval_s=0.1)
    eng = slo_mod.install(
        [slo_mod.availability("t-top-avail", good="wire_requests_total",
                              bad="wire_backend_retired_total", target=0.999)],
        interval_s=0.05, window_scale=0.001)
    try:
        rng = np.random.RandomState(0)
        for _ in range(5):
            fleet.infer({"x": rng.rand(2, IN_DIM).astype("float32")})
        deadline = time.monotonic() + 5
        while eng._ticks == 0 and time.monotonic() < deadline:
            time.sleep(0.02)
        fleet.scrape_once()
        host, port = fleet.admin_address
        out, real = io.StringIO(), sys.stdout
        sys.stdout = out
        try:
            rc = fleet_top.main(["%s:%d" % (host, port), "--once", "--no-color"])
        finally:
            sys.stdout = real
        frame = out.getvalue()
        assert rc == 0
        assert "t-topfleet" in frame and "BACKEND" in frame and "2/2 alive" in frame
        assert "t-top-avail" in frame
        assert fleet_top.main(["127.0.0.1:1", "--once", "--no-color"]) == 1
    finally:
        slo_mod.uninstall()
        fleet.stop()
        for sp in sps:
            sp.stop()


def test_fleet_top_dtype_column_matches_the_jax_copy():
    import os
    import sys

    from paddle_tpu_torch.tools import fleet_top

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                    "tools"))
    import fleet_top as jfleet_top

    m = {"qps": 1.0, "precision": "bf16", "kv_dtype": "int8", "row_dtype": "int8"}
    for metrics, reg in ((m, {}), ({"qps": 1.0}, {})):
        assert fleet_top._dtype_tag(metrics, reg) == jfleet_top._dtype_tag(metrics, reg)


@pytest.mark.parametrize("doc", [
    {"arrival_histogram": {"3": 120, "5": 60}, "max_batch_size": 16,
     "queue_wait_ewma_ms": 8.0, "batch_timeout_ms": 2.0},
    {"metrics": {"arrival_histogram": {"3": 10}, "bucket_ladder": [1, 2, 4, 8]}},
    {"uniq_id_histogram": {"37": 120, "61": 60, "300": 3}, "max_unique": 512},
    {"decode": {"seq_len_histogram": {"24": 120, "40": 7}, "max_seq_len": 128,
                "len_ladder": [32, 64, 128]}},
])
def test_autotune_ladder_tool_proposes_what_the_jax_copy_does(tmp_path, doc):
    import os
    import sys

    from paddle_tpu_torch.tools import autotune_ladder

    p = tmp_path / "hist.json"
    p.write_text(json.dumps(doc))
    out, real = io.StringIO(), sys.stdout
    sys.stdout = out
    try:
        rc = autotune_ladder.main([str(p)])
    finally:
        sys.stdout = real
    assert rc == 0
    got = json.loads(out.getvalue().strip().splitlines()[-1])
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                    "tools"))
    import autotune_ladder as jtool

    assert got == json.loads(json.dumps(jtool.propose(doc), sort_keys=True))
    if "arrival_histogram" in doc:
        assert got["ladder"] == [3, 5, 16]
