"""Config 1's pipeline through the port against the reference package.

``fluentbit_tpu_torch.create(device="cpu")`` and ``fluentbit_tpu.create()``
take the same lib-input records (made from a seed, with fixed timestamps)
through grep and must hand their lib outputs the same bytes. Also: the
port never imports the reference package or JAX, never loads or builds a
library of the reference's ``native/`` (its host codec is its own
``csrc/codec_host.cpp``), and asks for CUDA unless told otherwise.
"""

import ast
import json
import math
import pathlib
import random
import subprocess
import sys

import pytest
import torch

import fluentbit_tpu
import fluentbit_tpu_torch
from fluentbit_tpu_torch.codec.events import decode_events

REPO = pathlib.Path(__file__).resolve().parents[1]


def push_ordered(events, time_of=lambda ev: ev.ts_float):
    """One tag's events as the reference delivered them, stably sorted
    by the whole second of their time: the order of the pushes, in every
    test that gives a tag's records increasing seconds over its appends.
    That is what the reference's order is held to. It orders a tag's
    chunks only within one flush cycle: its ``flush_now`` runs a cycle on
    the caller's thread beside the timer's on the engine's loop
    (fluentbit_tpu/core/engine.py:2205-2207), so two cycles can queue one
    tag's chunks in either order, and the stable sort keeps each chunk's
    own order. The port's events are compared as they came: all its
    cycles run on its loop, in the order of the pushes."""
    return sorted(events, key=lambda ev: math.floor(time_of(ev)))


def push_ordered_bytes(data: bytes) -> bytes:
    """``push_ordered`` over the events of one tag's bytes."""
    return b"".join(ev.raw for ev in push_ordered(decode_events(data)))

APACHE2 = (
    r'^(?<host>[^ ]*) [^ ]* (?<user>[^ ]*) \[(?<time>[^\]]*)\] '
    r'"(?<method>\S+)(?: +(?<path>[^ ]*) +\S*)?" '
    r'(?<code>[^ ]*) (?<size>[^ ]*)'
    r'(?: "(?<referer>[^\"]*)" "(?<agent>.*)")?$'
)


def make_appends(seed, sizes=(64, 5, 40)):
    """Appends of [ts, body] pairs: apache lines, junk, non-ASCII,
    missing and non-string fields, and values past max_len."""
    rng = random.Random(seed)
    appends = []
    i = 0
    for n in sizes:
        recs = []
        for _ in range(n):
            kind = rng.randrange(8)
            code = rng.choice(["200", "404", "500"])
            line = (f'10.0.0.{i % 256} - u{i} [10/Oct/2000:13:55:36 -0700] '
                    f'"{rng.choice(["GET", "POST"])} /p/{i} HTTP/1.1" '
                    f'{code} {rng.randrange(9999)}')
            if kind == 0:
                body = {"log": line, "code": code}
            elif kind == 1:
                body = {"log": line + ' "-" "curl ünï"', "code": code}
            elif kind == 2:
                body = {"log": f"GET junk DENY {i}", "code": code}
            elif kind == 3:
                body = {"msg": "no log field"}
            elif kind == 4:
                body = {"log": i}
            elif kind == 5:  # longer than tpu_max_record_len
                body = {"log": line + ' "-" "' + "a" * 600 + '"',
                        "code": code}
            elif kind == 6:
                body = {"log": "POST 日本 " + "x" * rng.randrange(40)}
            else:
                body = {"log": ""}
            recs.append([1700000000 + i + 0.25, body])
            i += 1
        appends.append(recs)
    return appends


def run_pipeline(create, appends, rules, **create_kw):
    out = []
    ctx = create(flush="50ms", grace="1", **create_kw)
    in_ffd = ctx.input("lib", tag="app.log")
    f = ctx.filter("grep", match="app.*")
    for key, value in rules:
        ctx.set(f, **{key: value})
    ctx.output("lib", match="*", callback=lambda data, tag: out.append(data))
    ctx.start()
    try:
        for recs in appends:
            ctx.push(in_ffd, json.dumps(recs))
    finally:
        ctx.stop()
    return b"".join(out), ctx


RULE_SETS = {
    "config1_apache2": [("regex", "log " + APACHE2)],
    "legacy": [("exclude", "log DENY"), ("regex", "log ^10\\.0\\.0\\.")],
    "and": [("logical_op", "and"), ("regex", "log GET"),
            ("regex", "code ^[24]")],
    "or": [("logical_op", "or"), ("exclude", "log 500"),
           ("exclude", "log ünï")],
    "exclude": [("exclude", "log " + APACHE2)],
}


@pytest.mark.parametrize("name", sorted(RULE_SETS))
def test_lib_output_bytes_match_reference(name):
    appends = make_appends(seed=len(name))
    rules = RULE_SETS[name]
    ref, _ = run_pipeline(fluentbit_tpu.create, appends, rules)
    got, ctx = run_pipeline(fluentbit_tpu_torch.create, appends, rules,
                            device="cpu")
    assert got == ref
    assert len(ref) > 0
    # appends of >= tpu_batch_records (32) took the device program on
    # the raw chunk path; the smaller one declined to the decoded path's
    # per-record regex
    grep = ctx.engine.filters[0].plugin
    assert grep._program is not None
    assert grep.raw_timings["records"] == sum(len(a) for a in appends
                                              if len(a) >= 32)
    assert len(grep.match_seconds) == 0


def test_create_without_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        fluentbit_tpu_torch.create()
    with pytest.raises(RuntimeError, match="CUDA"):
        fluentbit_tpu_torch.create(device="cuda")
    assert fluentbit_tpu_torch.create(device="cpu").device.type == "cpu"


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0]


#: modules of the port that each slice added, by slice
PORT_MODULES = (
    "ops/grep.py", "plugins/filter_grep.py",  # config 1
    "core/metrics.py", "ops/sketch.py", "plugins/in_emitter.py",
    "plugins/filter_log_to_metrics.py", "plugins/net_http.py",  # config 4
    "flux/kernels.py", "flux/state.py", "flux/exporter.py",
    "flux/plugin.py",  # the flux plane
    "plugins/filter_rewrite_tag.py", "plugins/in_tail.py",
    "core/record_accessor.py", "regex/__init__.py",  # config 3
    "native.py", "core/chunk_batch.py", "ops/mesh.py",  # the raw path, K5
    "plugins/net_forward.py", "core/relay.py", "core/upstream.py",
    "utils/__init__.py", "plugins/filter_kubernetes.py",
    "config_format/__init__.py",  # config 5 and the config loader
    "codec/_native_codec.py",  # the event codec extension
    "core/scheduler.py", "core/bucket_queue.py", "core/conditions.py",
    "core/output_thread.py",  # the delivery core
    "core/guard.py", "core/tls.py", "core/fstore.py", "core/sidecar.py",
    "__main__.py", "supervisor.py",  # the relay tier and the CLI
    "failpoints/__init__.py", "ops/device.py",  # the guard's slice
    "core/storage.py", "failpoints/soak.py",  # storage and backpressure
)

#: what a module that loads or builds the reference's native library or
#: its C codec would name
REFERENCE_NATIVE = ("native/build", "fbtpu_native", "fbtpu_codec")


def _code_strings(path):
    """The string constants of a module's code, docstrings left out."""
    tree = ast.parse(path.read_text(), filename=str(path))
    docs = {id(node.body[0].value) for node in ast.walk(tree)
            if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                                 ast.AsyncFunctionDef))
            and node.body and isinstance(node.body[0], ast.Expr)
            and isinstance(node.body[0].value, ast.Constant)}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                and id(node) not in docs):
            yield node.value


def test_port_imports_neither_jax_nor_reference_package():
    files = sorted((REPO / "fluentbit_tpu_torch").rglob("*.py"))
    for module in PORT_MODULES:
        assert REPO / "fluentbit_tpu_torch" / module in files, module
    files.append(REPO / "chip_smoke.py")
    for path in files:
        roots = set(_imported_roots(path))
        assert not roots & {"jax", "jaxlib", "fluentbit_tpu"}, path
        for text in _code_strings(path):
            assert not any(name in text for name in REFERENCE_NATIVE), (
                path, text)
            assert text != "native", (path, text)


def test_import_loads_no_jax_or_reference_module():
    modules = ", ".join("fluentbit_tpu_torch." + m[:-3].replace("/", ".")
                        for m in PORT_MODULES)
    # the host codec and the event codec extension are loaded too: the
    # process maps the port's own libraries, the extension built from
    # csrc/codec_py.cpp, and none built from the reference's native/
    code = (
        f"import sys, fluentbit_tpu_torch, {modules}\n"
        "from fluentbit_tpu_torch.codec import _native_codec, events\n"
        "from fluentbit_tpu_torch.ops import cuda_build\n"
        "assert _native_codec.load.cache_info().currsize == 0\n"
        "assert fluentbit_tpu_torch.native.available()\n"
        "events.decode_events(events.encode_event({'a': 1}, 1.0))\n"
        "mod = _native_codec.load()\n"
        "assert mod.__file__ == str(cuda_build.library_path('codec_py'))\n"
        "assert cuda_build.source_path('codec_py').name == 'codec_py.cpp'\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'fluentbit_tpu', 'triton', 'fbtpu_codec')]\n"
        "maps = open('/proc/self/maps').read()\n"
        "bad += [n for n in ('fbtpu_native', 'native/build', 'fbtpu_codec.')"
        " if n in maps]\n"
        "assert 'libcodec_host-' in maps and 'libcodec_py-' in maps\n"
        "print(','.join(bad))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == ""
