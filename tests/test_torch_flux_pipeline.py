"""The flux pipeline through the port against the reference package.

FLUX.md's worked per-tenant example (lib input tagged ``app.web`` →
``flux`` filter: group_by tenant, distinct_field user, aggregate_field
latency_ms, topk_field endpoint, topk 10, window tumbling 60, tag
flux.tenants → lib output) runs through
``fluentbit_tpu_torch.create(device="cpu")`` and ``fluentbit_tpu.create()``
fed the same appends under one injected window clock. The records pass
through untouched, the closed-window rows (through the filter's hidden
emitter, and drained at stop) and the ``fluentbit_flux_*`` exposition
must be equal, and the filter must not absorb the rows it emits itself.
"""

import json
import random

import pytest

import fluentbit_tpu
import fluentbit_tpu_torch
from fluentbit_tpu_torch.codec.events import decode_events

FLUX = dict(match="app.*", group_by="tenant", distinct_field="user",
            aggregate_field="latency_ms", topk_field="endpoint", topk="10",
            window="tumbling 60", tag="flux.tenants")


def make_appends(seed, sizes=(40, 25, 60, 10, 33, 7)):
    """Appends of [ts, body] pairs: tenants (some missing), users,
    endpoints (some longer than max_field_len), latencies as ints, floats
    and non-numeric values."""
    rng = random.Random(seed)
    appends = []
    i = 0
    for n in sizes:
        recs = []
        for _ in range(n):
            body = {"tenant": rng.choice(["acme", "globex", "initech"]),
                    "user": f"user-{rng.randrange(30)}",
                    "endpoint": f"/api/v1/{rng.randrange(8)}",
                    "latency_ms": rng.choice([rng.randrange(3000),
                                              rng.random() * 100, "slow"])}
            x = rng.random()
            if x < 0.05:
                del body["tenant"]
            elif x < 0.1:
                body["endpoint"] += "/" + "e" * 300
            elif x < 0.15:
                del body["user"]
            recs.append([1700000000 + i * 0.25, body])
            i += 1
        appends.append(recs)
    return appends


def run_flux(create, appends, step=15.0, **create_kw):
    """Push the appends; before append k the window clock reads 1000 +
    step·k and the filter's own tick runs. Returns the lib output's
    (tag, bytes) pairs, the rows drained at stop, the flux exposition
    lines and the filter's plugin."""
    out = []
    ctx = create(flush="50ms", grace="1", **create_kw)
    in_ffd = ctx.input("lib", tag="app.web")
    ctx.filter("flux", **FLUX)
    ctx.output("lib", match="*",
               callback=lambda data, tag: out.append((tag, data)))
    ctx.start()
    engine = ctx.engine
    plug = engine.filters[0].plugin
    clock = [1000.0]
    with engine._ingest_lock:
        plug.state._now = lambda: clock[0]
        plug.state._window_start = clock[0]
    try:
        for k, recs in enumerate(appends):
            clock[0] = 1000.0 + step * k
            plug._on_tick(engine)
            assert ctx.push(in_ffd, json.dumps(recs)) == len(recs)
        ctx.flush_now()
        plug.exporter.refresh()
        text = engine.metrics.to_prometheus()
    finally:
        ctx.stop()
    drained = [c.get_bytes() for c in plug._emitter_ins.pool.drain()]
    lines = [ln for ln in text.splitlines() if "fluentbit_flux_" in ln]
    return out, drained, lines, plug


def rows(chunks):
    return [ev.body for data in chunks for ev in decode_events(data)]


def by_tag(out, tag):
    return [data for t, data in out if t == tag]


@pytest.fixture(scope="module")
def both():
    appends = make_appends(seed=7)
    return (appends,
            run_flux(fluentbit_tpu.create, appends),
            run_flux(fluentbit_tpu_torch.create, appends, device="cpu"))


def test_records_pass_through_untouched(both):
    appends, _ref, (out, _, _, _) = both
    got = [[ev.timestamp, ev.body]
           for ev in decode_events(b"".join(by_tag(out, "app.web")))]
    assert [[float(ts), body] for ts, body in got] == [
        [ts, body] for recs in appends for ts, body in recs]


def test_window_rows_equal_reference(both):
    _, (ref_out, ref_drained, _, _), (out, drained, _, plug) = both
    want = rows(by_tag(ref_out, "flux.tenants"))
    got = rows(by_tag(out, "flux.tenants"))
    assert got == want
    # 6 appends 15 s apart: the window of appends 0-3 closed by a tick
    assert {r["tenant"] for r in got} >= {"acme", "globex", "initech"}
    assert all(r["flux"] == "flux.0" for r in got)
    assert sum(r["count"] for r in got) == 40 + 25 + 60 + 10
    assert rows(drained) == rows(ref_drained)
    assert sum(r["count"] for r in rows(drained)) == 33 + 7
    assert plug.state.window_emits_total == 1


def test_filter_skips_its_own_emitted_rows():
    """With Match covering the emitter's tag, the window rows re-enter
    the chain and the filter lets them through without absorbing them."""
    appends = make_appends(seed=8, sizes=(20, 20, 20, 20, 5))
    FLUX["match"] = "*"
    try:
        out, _, _, plug = run_flux(fluentbit_tpu_torch.create, appends,
                                   device="cpu")
    finally:
        FLUX["match"] = "app.*"
    assert rows(by_tag(out, "flux.tenants"))
    assert plug.state.records_total == 85
    assert plug.state.batches_total == 5


def test_exposition_equals_reference(both):
    _, (_, _, want, _), (_, _, got, _) = both
    assert got == want
    assert any(ln.startswith("fluentbit_flux_cardinality{") for ln in got)
    assert any(ln.startswith("fluentbit_flux_topk_estimate{") for ln in got)
    assert 'fluentbit_flux_records_total{name="flux.0"} 175' in got


def test_two_exporters_do_not_clobber_each_other():
    """The flux families are shared engine metrics: one instance's
    refresh drops only its own series."""
    ctx = fluentbit_tpu_torch.create(device="cpu", flush="50ms", grace="1")
    in_ffd = ctx.input("lib", tag="app.web")
    for alias in ("one", "two"):
        ctx.filter("flux", match="app.*", alias=alias, group_by="tenant",
                   distinct_field="user", export_interval_sec="0")
    ctx.start()
    try:
        ctx.push(in_ffd, json.dumps([{"tenant": "a", "user": f"u{i}"}
                                     for i in range(5)]))
        f1, f2 = (f.plugin for f in ctx.engine.filters)
        f1.exporter.refresh()
        f2.exporter.refresh()
        text = ctx.engine.metrics.to_prometheus()
    finally:
        ctx.stop()
    card = [ln for ln in text.splitlines()
            if ln.startswith("fluentbit_flux_cardinality")]
    assert any('name="one"' in ln for ln in card)
    assert any('name="two"' in ln for ln in card)
    assert 'fluentbit_flux_cardinality{name="one",group="a",field="user"} ' \
        '5.003' in text
