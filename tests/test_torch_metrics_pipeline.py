"""Config 4's pipeline through the port against the reference package.

BASELINE config 4 (``conf/baseline4-metrics.yaml``: http input →
log_to_metrics cardinality (HLL over ``user``) and frequency (count-min
over ``path``, top 10) → prometheus_exporter) runs through
``fluentbit_tpu_torch.create(device="cpu")`` and through
``fluentbit_tpu.create()``, fed the same POST bodies (made from a seed);
the rendered Prometheus text, the HLL registers, the count-min table and
the top-k label sets must be equal. Also: the host-only modes (counter,
gauge, histogram) against the reference filter, the emitter's typed
append from inside the filter chain, and the HTTP input's
Content-Encoding handling.
"""

import gzip
import http.client
import json
import random
import socket
import threading
import time
import zlib

import numpy as np
import pytest

import fluentbit_tpu
import fluentbit_tpu_torch
from fluentbit_tpu_torch.codec.events import decode_events

CARDINALITY = dict(match="firehose", metric_mode="cardinality",
                   metric_name="unique_users",
                   metric_description="distinct user ids (HLL estimate)",
                   value_field="user", tag="metrics")
FREQUENCY = dict(match="firehose", metric_mode="frequency",
                 metric_name="hot_paths",
                 metric_description="hottest request paths (count-min "
                                    "estimate)",
                 value_field="path", frequency_top_k="10", tag="metrics")


def make_posts(seed, n_posts=4, per_post=300):
    """JSON-array bodies: users from ~400 ids, Zipf-like paths, ~3% of
    records without the field, ~3% of values longer than 256 B, and
    non-string values (stringified by the filter)."""
    rng = random.Random(seed)
    posts = []
    for _ in range(n_posts):
        recs = []
        for i in range(per_post):
            rec = {"user": f"user-{rng.randrange(400)}",
                   "path": f"/api/{int(rng.paretovariate(1.1)) % 50}"}
            x = rng.random()
            if x < 0.03:
                del rec["user"]
            elif x < 0.06:
                del rec["path"]
            elif x < 0.09:
                rec["user"] += "u" * 300
                rec["path"] += "/" + "p" * 300
            elif x < 0.11:
                rec["user"] = rng.randrange(100)
                rec["path"] = 7.0
            recs.append(rec)
        posts.append(json.dumps(recs).encode())
    return posts


def wait_port(plugin):
    deadline = time.time() + 10
    while plugin.bound_port is None and time.time() < deadline:
        time.sleep(0.01)
    assert plugin.bound_port is not None
    return plugin.bound_port


def post(port, body, encoding=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    headers = {"Content-Type": "application/json"}
    if encoding:
        headers["Content-Encoding"] = encoding
    conn.request("POST", "/", body=body, headers=headers)
    resp = conn.getresponse()
    resp.read()
    conn.close()
    return resp.status


def run_config4(create, posts, **create_kw):
    """The posts over one keep-alive connection, the second gzip- and
    the third deflate-encoded; returns (render text, hll, cms filter)."""
    ctx = create(flush="50ms", grace="1", **create_kw)
    ctx.input("http", tag="firehose", port=0, listen="127.0.0.1")
    ctx.filter("log_to_metrics", **CARDINALITY)
    ctx.filter("log_to_metrics", **FREQUENCY)
    ctx.output("prometheus_exporter", match="metrics")
    exporter = ctx.engine.outputs[-1].plugin
    ctx.start()
    try:
        port = wait_port(ctx.engine.inputs[0].plugin)
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
        for i, body in enumerate(posts):
            headers = {"Content-Type": "application/json"}
            if i % 4 == 1:
                body, headers["Content-Encoding"] = gzip.compress(body), "gzip"
            elif i % 4 == 2:
                body, headers["Content-Encoding"] = zlib.compress(body), "deflate"
            conn.request("POST", "/", body=body, headers=headers)
            resp = conn.getresponse()
            resp.read()
            assert resp.status == 201
        conn.close()
        ctx.flush_now()
    finally:
        ctx.stop()
    filters = [f.plugin for f in ctx.engine.filters]
    return exporter.render(), filters[0], filters[1]


def top_labels(text):
    return sorted(line.split("value=")[1].split("}")[0]
                  for line in text.splitlines()
                  if line.startswith("log_metric_hot_paths{"))


def test_config4_equals_reference():
    posts = make_posts(seed=4)
    ref_text, ref_hll, ref_cms = run_config4(fluentbit_tpu.create, posts)
    text, hll, cms = run_config4(fluentbit_tpu_torch.create, posts,
                                 device="cpu")
    assert text == ref_text
    assert np.array_equal(hll.hll.registers.numpy(),
                          np.asarray(ref_hll.hll.registers))
    assert np.array_equal(cms.cms.table.numpy(), np.asarray(ref_cms.cms.table))
    assert top_labels(text) == top_labels(ref_text)
    assert len(top_labels(text)) == 10
    assert "log_metric_unique_users " in text
    # one sketch append per POST in each filter, no launch on the CPU
    assert len(hll.step_seconds) == len(cms.step_seconds) == len(posts)
    assert list(cms._freq_candidates) == list(ref_cms._freq_candidates)


MODES = {
    "counter": ({"regex": "log error", "label_field": "svc",
                 "add_label": "team core"}, False),
    "counter_k8s": ({"kubernetes_mode": "on"}, False),
    "gauge": ({"metric_mode": "gauge", "value_field": "d",
               "label_field": "svc"}, False),
    "histogram": ({"metric_mode": "histogram", "value_field": "d",
                   "bucket": ["0.01", "0.5", "2.0"]}, False),
    "histogram_default_buckets": ({"metric_mode": "histogram",
                                   "value_field": "d",
                                   "exclude": "svc web"}, True),
}


def run_host_mode(create, props, records, **create_kw):
    ctx = create(flush="50ms", grace="1", **create_kw)
    in_ffd = ctx.input("lib", tag="logs")
    listed = {k: v for k, v in props.items() if isinstance(v, list)}
    f = ctx.filter("log_to_metrics", match="logs", metric_name="m",
                   metric_description="d", tag="metrics",
                   **{k: v for k, v in props.items() if k not in listed})
    for k, vs in listed.items():
        for v in vs:
            ctx.set(f, **{k: v})
    ctx.output("prometheus_exporter", match="metrics", add_label="env prod")
    exporter = ctx.engine.outputs[-1].plugin
    ctx.start()
    try:
        for chunk in (records[:7], records[7:]):
            ctx.push(in_ffd, json.dumps(chunk))
        ctx.flush_now()
    finally:
        ctx.stop()
    return exporter.render()


@pytest.mark.parametrize("mode", sorted(MODES))
def test_host_modes_equal_reference(mode):
    props, discard = MODES[mode]
    if discard:
        props = dict(props, discard_logs="on")
    rng = random.Random(len(mode))
    records = []
    for i in range(20):
        rec = {"log": rng.choice(["error A", "error B", "ok"]),
               "svc": rng.choice(["api", "web", 3]),
               "d": rng.choice([0.2, 1.7, 0.009, 4, "3.5", "x", True]),
               "kubernetes": {"namespace_name": "prod", "pod_name": f"p{i % 3}",
                              "container_name": "c", "docker_id": "d",
                              "pod_id": i % 2}}
        if i % 5 == 0:
            del rec["d"]
        records.append(rec)
    ref = run_host_mode(fluentbit_tpu.create, props, records)
    got = run_host_mode(fluentbit_tpu_torch.create, props, records,
                        device="cpu")
    assert got == ref
    assert "log_metric_m" in got and 'env="prod"' in got


def test_snapshot_emit_from_filter_chain_completes():
    """log_to_metrics appends its snapshot (the emitter's typed append)
    while the chain holds the engine's ingest lock; the lock is
    reentrant, so the append returns instead of deadlocking."""
    ctx = fluentbit_tpu_torch.create(device="cpu", flush="50ms", grace="1")
    in_ffd = ctx.input("lib", tag="logs")
    ctx.filter("log_to_metrics", match="logs", metric_name="hits",
               metric_description="hits", tag="metrics")
    ctx.output("prometheus_exporter", match="metrics")
    ctx.start()
    try:
        got = []
        worker = threading.Thread(
            target=lambda: got.append(ctx.push(in_ffd, '{"log": "x"}')),
            daemon=True)
        worker.start()
        worker.join(timeout=10)
        assert not worker.is_alive(), "snapshot append deadlocked"
        assert got == [1]
        ctx.flush_now()
    finally:
        ctx.stop()
    emitter = ctx.engine.inputs[-1]
    assert emitter.plugin.name == "emitter"
    assert emitter.display_name == "emitter_for_log_to_metrics.0"
    assert "log_metric_hits 1\n" in ctx.engine.outputs[0].plugin.render()


def test_http_content_encoding():
    """identity and gzip bodies are ingested; an unknown encoding and a
    body that does not decode answer 400 and ingest nothing."""
    out = []
    ctx = fluentbit_tpu_torch.create(device="cpu", flush="50ms", grace="1")
    ctx.input("http", tag="t", port=0, listen="127.0.0.1")
    ctx.output("lib", match="*", callback=lambda data, tag: out.append(
        (tag, data)))
    ctx.start()
    try:
        port = ctx.engine.inputs[0].plugin.bound_port  # bound by start()
        body = json.dumps([{"a": 1}, {"a": 2}]).encode()
        assert post(port, body) == 201
        assert post(port, gzip.compress(body), "gzip") == 201
        assert post(port, body, "br") == 400
        assert post(port, b"not gzip", "gzip") == 400
        assert post(port, b"[1, 2]") == 400
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
        conn.request("GET", "/")
        assert conn.getresponse().status == 400
        conn.close()
        ctx.flush_now()
    finally:
        ctx.stop()
    bodies = [ev.body for tag, data in out for ev in decode_events(data)]
    assert bodies == [{"a": 1}, {"a": 2}] * 2
    assert {tag for tag, _ in out} == {"t"}


def test_http_start_raises_when_port_taken():
    """A listener that cannot bind fails ``start()`` with the cause."""
    with socket.socket() as taken:
        taken.bind(("127.0.0.1", 0))
        taken.listen()
        ctx = fluentbit_tpu_torch.create(device="cpu", flush="50ms",
                                         grace="1")
        ctx.input("http", tag="t", port=taken.getsockname()[1],
                  listen="127.0.0.1")
        with pytest.raises(RuntimeError, match="failed to start") as err:
            ctx.start()
        assert isinstance(err.value.__cause__, OSError)
        assert not ctx.engine.running


def test_flush_interval_emits_from_the_emitter_timer():
    """With ``flush_interval_*`` set, appends only mark the registry
    dirty; the hidden emitter's interval collector emits the snapshot."""
    ctx = fluentbit_tpu_torch.create(device="cpu", flush="50ms", grace="1")
    in_ffd = ctx.input("lib", tag="logs")
    ctx.filter("log_to_metrics", match="logs", metric_name="hits",
               metric_description="hits", tag="metrics",
               flush_interval_nsec="100000000")
    ctx.output("prometheus_exporter", match="metrics")
    ctx.start()
    try:
        lm = ctx.engine.filters[0].plugin
        emitted_by = []
        emit = lm._emit_snapshot
        lm._emit_snapshot = lambda: (
            emitted_by.append(threading.current_thread().name), emit())[1]
        assert ctx.push(in_ffd, '[{"log": "a"}, {"log": "b"}]') == 2
        deadline = time.time() + 10
        while not emitted_by and time.time() < deadline:
            time.sleep(0.02)
        ctx.flush_now()
    finally:
        ctx.stop()
    # emitted by the engine's timer, never by the appending thread
    assert emitted_by and set(emitted_by) == {"flb-engine"}
    assert "log_metric_hits 2\n" in ctx.engine.outputs[0].plugin.render()
