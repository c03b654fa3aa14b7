"""Config 1's raw chunk path in the port against the reference package.

``fluentbit_tpu_torch.create(device="cpu")`` takes lib-input appends
through grep on the raw path (the host codec stages the field straight
from the msgpack bytes, the DFA's plain version matches, survivors are
copied as byte spans) and must hand its lib output the same bytes as the
reference package and as the port's own decoded path. Also: the
double-buffered pipeline's order and error propagation, small appends
declining to the decoded path, overflow rows, multi-segment chunks,
staging over dirty buffers, and that a failed launch or build raises out
of the append with no fallback.
"""

import json

import numpy as np
import pytest
import torch

import fluentbit_tpu
import fluentbit_tpu_torch
from fluentbit_tpu_torch import native
from fluentbit_tpu_torch.codec.events import encode_event
from fluentbit_tpu_torch.codec.msgpack import EventTime
from fluentbit_tpu_torch.core import engine as engine_mod
from fluentbit_tpu_torch.core.chunk_batch import (RawChunk, double_buffered,
                                                  segment_bounds)
from fluentbit_tpu_torch.ops import cuda_build
from fluentbit_tpu_torch.ops.device import DeviceError
from fluentbit_tpu_torch.ops import grep as tg
from fluentbit_tpu_torch.plugins import filter_grep
from fluentbit_tpu_torch.plugins.filter_grep import GrepFilter
from fluentbit_tpu_torch.regex.dfa import compile_dfa
from test_torch_pipeline import APACHE2, RULE_SETS, make_appends, run_pipeline

RULE_SETS_RAW = dict(RULE_SETS, both=[("exclude", "log DENY"),
                                      ("regex", "log " + APACHE2)])


def test_segment_bounds():
    assert segment_bounds(0, 64) == [(0, 0)]
    assert segment_bounds(64, 64) == [(0, 64)]
    assert segment_bounds(65, 64) == [(0, 64), (64, 65)]
    assert segment_bounds(300, 128) == [(0, 128), (128, 256), (256, 300)]
    assert segment_bounds(300, 0) == [(0, 300)]


def test_double_buffered_order_and_raise():
    trace = []

    def stages(n, fail_at=None):
        for i in range(n):
            if i == fail_at:
                raise ValueError("staging failed")
            trace.append(("stage", i))
            yield i

    def dispatch(i):
        trace.append(("launch", i))
        return torch.tensor([i * 10])

    def collect(t):
        trace.append(("read", int(t[0]) // 10))
        return int(t[0])

    assert double_buffered(stages(3), dispatch, collect) == [0, 10, 20]
    # segment N is read back only after N+1 was staged and launched
    assert trace == [("stage", 0), ("launch", 0), ("stage", 1),
                     ("launch", 1), ("read", 0), ("stage", 2),
                     ("launch", 2), ("read", 1), ("read", 2)]
    assert [a.tolist() for a in double_buffered(stages(2), dispatch)] == [
        [0], [10]]
    with pytest.raises(ValueError, match="staging failed"):
        double_buffered(stages(4, fail_at=2), dispatch, collect)

    def bad_collect(t):
        raise RuntimeError("readback failed")

    with pytest.raises(RuntimeError, match="readback failed"):
        double_buffered(stages(3), dispatch, bad_collect)
    chunk = RawChunk(memoryview(b"ab"), "t")
    assert chunk.as_bytes() == b"ab" and isinstance(chunk.data, bytes)
    chunk.replace(b"c", 1)
    assert (chunk.data, chunk.n) == (b"c", 1)


def _decoded_only(monkeypatch):
    monkeypatch.setattr(GrepFilter, "can_filter_raw", lambda self: False)


@pytest.mark.parametrize("name", sorted(RULE_SETS_RAW))
def test_raw_output_equals_reference_and_decoded(name, monkeypatch):
    appends = make_appends(seed=100 + len(name), sizes=(64, 5, 300, 40))
    rules = RULE_SETS_RAW[name]
    ref, _ = run_pipeline(fluentbit_tpu.create, appends, rules)
    got, ctx = run_pipeline(fluentbit_tpu_torch.create, appends, rules,
                            device="cpu")
    grep = ctx.engine.filters[0].plugin
    assert got == ref and len(ref) > 0
    # every append of >= 32 records went raw; none through the decoded
    # path's device match
    assert grep.raw_timings["records"] == 64 + 300 + 40
    assert len(grep.match_seconds) == 0
    assert len(grep.raw_step_seconds) == 3
    _decoded_only(monkeypatch)
    decoded, dctx = run_pipeline(fluentbit_tpu_torch.create, appends, rules,
                                 device="cpu")
    assert decoded == got
    assert dctx.engine.filters[0].plugin.raw_timings["records"] == 0
    assert len(dctx.engine.filters[0].plugin.match_seconds) == 3


def test_small_appends_decline_to_decoded_path():
    appends = make_appends(seed=7, sizes=(5, 31, 1))
    rules = RULE_SETS["legacy"]
    ref, _ = run_pipeline(fluentbit_tpu.create, appends, rules)
    got, ctx = run_pipeline(fluentbit_tpu_torch.create, appends, rules,
                            device="cpu")
    assert got == ref
    grep = ctx.engine.filters[0].plugin
    assert grep.raw_timings["records"] == 0 and not grep.match_seconds


def test_dummy_input_raw_path():
    out = []
    ctx = fluentbit_tpu_torch.create(device="cpu", flush="50ms", grace="1")
    ctx.input("dummy", tag="t", dummy='{"log":"GET /x 200"}', rate=200,
              samples=6)
    f = ctx.filter("grep", match="t", tpu_batch_records="1")
    ctx.set(f, exclude="log DENY")
    ctx.output("lib", match="*", callback=lambda d, t: out.append(d))
    ctx.start()
    try:
        import time

        deadline = time.time() + 10
        while ctx.engine.filters[0].plugin.raw_timings["records"] < 6:
            assert time.time() < deadline
            time.sleep(0.02)
        ctx.flush_now()
    finally:
        ctx.stop()
    from fluentbit_tpu_torch.codec.events import decode_events

    bodies = [ev.body for ev in decode_events(b"".join(out))]
    assert bodies == [{"log": "GET /x 200"}] * 6


def test_overflow_rows_and_segments(monkeypatch):
    """Values past tpu_max_record_len (-2 rows, re-checked on the host)
    and chunks of several segments (FBTPU_SEGMENT_RECORDS=64)."""
    monkeypatch.setenv("FBTPU_SEGMENT_RECORDS", "64")
    appends = make_appends(seed=11, sizes=(300, 64, 65, 200))
    rules = [("tpu_max_record_len", "96"), ("exclude", "log DENY"),
             ("regex", "log ^10\\.0\\.0\\.")]
    ref, _ = run_pipeline(fluentbit_tpu.create, appends, rules)
    calls = []
    real = tg.TorchGrepProgram.dispatch

    def counting(self, batch, lengths):
        calls.append(tuple(batch.shape))
        return real(self, batch, lengths)

    monkeypatch.setattr(tg.TorchGrepProgram, "dispatch", counting)
    got, ctx = run_pipeline(fluentbit_tpu_torch.create, appends, rules,
                            device="cpu")
    assert got == ref
    # 5 + 1 + 2 + 4 segments, all of 64 rows (seg 64 is not a bucket:
    # every segment rounds to 256); widths by the longest value
    assert len(calls) == 12
    assert all(c[:2] == (2, 256) and c[2] in (64, 96) for c in calls)
    assert ctx.engine.filters[0].plugin.raw_timings["records"] == 629


def _rows(rng, R, B, L):
    """Text rows with every length class; bytes past a length random."""
    batch = rng.integers(0, 256, size=(R, B, L), dtype=np.uint8)
    lengths = rng.integers(-2, L + 1, size=(R, B)).astype(np.int32)
    text = b'10.0.0.1 - u [10/Oct/2000:13:55:36 -0700] "GET /a HTTP/1.1" 200 7'
    for b in range(0, B, 3):
        n = min(len(text), L)
        batch[:, b, :n] = np.frombuffer(text[:n], np.uint8)
        lengths[:, b] = n
    return batch, lengths


@pytest.mark.parametrize("patterns,kernel", [
    ([APACHE2], "scan"),               # k = 3: K1's symbols
    (["GET", "DENY"], "scan"),         # k = 6: K2's pair tables
    (["GET|POST", "50[0-9]$"], "assoc"),
])
def test_dirty_staging_equals_zeroed(patterns, kernel):
    """The plain versions read nothing past a row's length: rows staged
    over 0xFF or random bytes give the verdicts of zeroed rows."""
    rng = np.random.default_rng(3)
    prog = tg.TorchGrepProgram([compile_dfa(p) for p in patterns], 80, "cpu",
                               kernel=kernel)
    batch, lengths = _rows(rng, len(patterns), 200, 80)
    pos = np.arange(80)[None, None, :]
    past = pos >= np.maximum(lengths, 0)[:, :, None]
    zeroed = np.where(past, 0, batch).astype(np.uint8)
    ones = np.where(past, 0xFF, batch).astype(np.uint8)
    want = prog.match(zeroed, lengths)
    assert want.any() and not want.all()
    assert np.array_equal(prog.match(ones, lengths), want)
    assert np.array_equal(prog.match(batch, lengths), want)


def test_dirty_staging_buffers_pipeline(monkeypatch):
    """The raw path over staging buffers pre-filled with 0xFF and random
    bytes writes the same output as the reference."""
    real = filter_grep.staging
    rng = np.random.default_rng(5)

    def dirty(shape, dtype, device, fill=0):
        t = real(shape, dtype, device, fill)
        if fill is None:
            t.copy_(torch.from_numpy(rng.integers(0, 256, size=shape,
                                                  dtype=np.uint8)))
        return t

    monkeypatch.setattr(filter_grep, "staging", dirty)
    appends = make_appends(seed=12, sizes=(64, 300))
    rules = RULE_SETS["config1_apache2"]
    ref, _ = run_pipeline(fluentbit_tpu.create, appends, rules)
    got, _ = run_pipeline(fluentbit_tpu_torch.create, appends, rules,
                          device="cpu")
    assert got == ref


def _started_ctx(rules):
    ctx = fluentbit_tpu_torch.create(device="cpu", flush="50ms", grace="1")
    ctx.input("lib", tag="app.log")
    f = ctx.filter("grep", match="app.*")
    for key, value in rules:
        ctx.set(f, **{key: value})
    ctx.output("null", match="*")
    ctx.start()
    return ctx


def _chunk(n):
    return b"".join(encode_event({"log": f"GET /{i} 200"}, EventTime(i, 0))
                    for i in range(n))


def test_failed_launch_raises_without_fallback(monkeypatch):
    """A launch that returns an error code raises DeviceError, which the
    raw path's host error policy (log and decline) does not take: the
    append raises, no decoded re-run, nothing pooled, and the engine
    counts it under lane grep."""
    decoded = []
    monkeypatch.setattr(engine_mod, "decode_events",
                        lambda data: decoded.append(data) or [])

    def boom(self, batch, lengths):
        raise DeviceError("grep_dfa failed: CUDA error 700")

    monkeypatch.setattr(tg.TorchGrepProgram, "dispatch", boom)
    ctx = _started_ctx([("regex", "log GET")])
    try:
        ins = ctx.engine.inputs[0]
        with pytest.raises(DeviceError, match="CUDA error 700"):
            ctx.engine.input_log_append(ins, "app.log", _chunk(64), 64)
        assert decoded == []
        assert ins.pool.drain() == []
        assert ctx.engine.m_device_failures.get(("grep",)) == 1
    finally:
        ctx.stop()


def test_failed_build_raises(monkeypatch, tmp_path):
    """A failed g++ or nvcc build raises, and a codec that cannot load
    makes the append raise."""
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path)
    libs = cuda_build.KernelLibraries()
    monkeypatch.setattr(cuda_build, "gxx", lambda: "false")
    with pytest.raises(RuntimeError, match="build of codec_host failed"):
        libs.build(["codec_host"])
    monkeypatch.setattr(cuda_build, "nvcc", lambda: "false")
    with pytest.raises(RuntimeError, match="build of grep_dfa failed"):
        libs.build(["grep_dfa"])
    assert not list(tmp_path.glob("*.so"))

    ctx = _started_ctx([("regex", "log GET")])
    try:
        native._load.cache_clear()
        monkeypatch.setattr(cuda_build, "libraries", libs)
        with pytest.raises(RuntimeError, match="build of codec_host failed"):
            ctx.push(0, json.dumps([[1, {"log": "GET /"}]] * 40))
    finally:
        ctx.stop()
        native._load.cache_clear()
