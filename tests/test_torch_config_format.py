"""The port's config loader against the reference's.

``fluentbit_tpu_torch.config_format`` parses classic and YAML configs
into the same sections as ``fluentbit_tpu.config_format`` (``@SET``,
``@INCLUDE``, ``${VAR}`` interpolation, YAML ``env:`` and
``includes:``), and ``apply_to_context`` builds the same plugin lists
from every ``conf/baseline*`` file (config 5's
``test_baseline5_constructible`` among them), with ``parsers_file`` and
``streams_file`` / ``[STREAM_TASK]`` applied. What the port does not
have raises by name: processors, DSO plugins, multiline parsers,
``[CUSTOM]``, YAML without PyYAML, and every unported instance or
service key. The delivery keys (service ``scheduler.base``,
``scheduler.cap``, ``retry_limit`` and ``task_map_size``; output
``retry_limit``, ``workers``, ``no_multiplex`` and ``route_condition``)
load as in the reference.
"""

import json
import os
import sys

import pytest

import fluentbit_tpu as ref
import fluentbit_tpu_torch as flb
from fluentbit_tpu import config_format as jcf
from fluentbit_tpu_torch import config_format as tcf
from fluentbit_tpu_torch.codec.events import decode_events

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONF = os.path.join(REPO, "conf")
BASELINES = sorted(f for f in os.listdir(CONF) if f.startswith("baseline"))


def sections(cf):
    return [(s.name, s.properties, s.processors) for s in cf.sections]


CLASSIC = """
# comment
@SET RATE=9
@SET TAGV=from_set
[SERVICE]
    Flush  2
    Grace  7

[INPUT]
    Name  dummy
    Tag   ${MYTAG}
    Rate  ${RATE}
    Dummy ${TAGV}.${UNSET}x

[FILTER]
    Name    grep
    Match   *
    Regex   log a b c
    Exclude log d

[OUTPUT]
    Name   stdout
    Match  *
"""

YAML = """
service:
  flush: 0.5
env:
  TOPIC: apps
pipeline:
  inputs:
    - name: dummy
      tag: ${TOPIC}.x
      rate: 3
  filters:
    - name: grep
      match: "*"
      regex:
        - log hi
        - msg there
  outputs:
    - name: "null"
      match: "*"
"""


def test_classic_equals_reference(monkeypatch):
    monkeypatch.setenv("MYTAG", "fromenv")
    monkeypatch.setenv("TAGV", "env_wins")
    got = tcf.parse_classic(CLASSIC)
    want = jcf.parse_classic(CLASSIC)
    assert sections(got) == sections(want)
    assert got.env == want.env
    inp = got.sections[1]
    assert (inp.get("tag"), inp.get("RATE"), inp.get("dummy")) == (
        "fromenv", "9", "env_wins.x")


def test_yaml_equals_reference():
    got, want = tcf.parse_yaml(YAML), jcf.parse_yaml(YAML)
    assert sections(got) == sections(want)
    assert [s.get("tag") for s in got.sections if s.name == "input"] == [
        "apps.x"]


def test_include_and_yaml_includes(tmp_path):
    (tmp_path / "extra.conf").write_text("[OUTPUT]\n Name null\n Match *\n")
    (tmp_path / "more.conf").write_text("@SET X=1\n[FILTER]\n Name grep\n")
    main = tmp_path / "main.conf"
    main.write_text("[INPUT]\n Name dummy\n@INCLUDE extra.conf\n"
                    "@INCLUDE mo*.conf\n")
    got = tcf.load_config_file(str(main))
    assert sections(got) == sections(jcf.load_config_file(str(main)))
    assert [s.name for s in got.sections] == ["input", "output", "filter"]
    assert got.env == {"X": "1"}
    y = tmp_path / "main.yaml"
    y.write_text("includes:\n  - extra.conf\npipeline:\n  inputs:\n"
                 "    - name: dummy\n")
    assert sections(tcf.load_config_file(str(y))) == sections(
        jcf.load_config_file(str(y)))


def names(ctx):
    e = ctx.engine
    return ([i.plugin.name for i in e.inputs],
            [f.plugin.name for f in e.filters],
            [o.plugin.name for o in e.outputs], sorted(e.parsers),
            e.service.flush, e.service.grace)


@pytest.mark.parametrize("conf", BASELINES)
def test_baseline_configs_construct_as_the_reference(conf):
    """Every shipped BASELINE config builds the reference's plugin lists,
    and every instance takes its keys (``configure``)."""
    path = os.path.join(CONF, conf)
    want = ref.create()
    jcf.apply_to_context(want, jcf.load_config_file(path), CONF)
    got = flb.create(device="cpu")
    tcf.apply_to_context(got, tcf.load_config_file(path), CONF)
    assert names(got) == names(want)
    e = got.engine
    for ins in e.inputs + e.filters + e.outputs:
        ins.configure()


def test_baseline5_constructible():
    ctx = flb.create(device="cpu")
    tcf.apply_to_context(
        ctx, tcf.load_config_file(os.path.join(CONF, "baseline5-k8s.conf")),
        CONF)
    assert [i.plugin.name for i in ctx.engine.inputs] == ["forward"]
    assert [f.plugin.name for f in ctx.engine.filters] == ["kubernetes",
                                                           "grep"]
    assert [o.plugin.name for o in ctx.engine.outputs] == ["null"]
    ctx.engine.inputs[0].configure()
    assert ctx.engine.inputs[0].plugin.port == 24224


def test_apply_to_context_runs_pipeline(tmp_path):
    conf = tmp_path / "p.conf"
    conf.write_text("""
[SERVICE]
    Flush  0.05
    Grace  1

[INPUT]
    Name  lib
    Tag   t

[FILTER]
    Name   grep
    Match  t
    Regex  log keep

[OUTPUT]
    Name     lib
    Match    t
""")
    ctx = flb.create(device="cpu")
    tcf.apply_to_context(ctx, tcf.load_config_file(str(conf)), str(tmp_path))
    assert ctx.engine.service.flush == 0.05
    got = []
    ctx.engine.outputs[0].set("callback", lambda d, t: got.append(d))
    ctx.start()
    try:
        ctx.push(0, json.dumps({"log": "keep me"}))
        ctx.push(0, json.dumps({"log": "drop me"}))
        ctx.flush_now()
    finally:
        ctx.stop()
    assert [e.body["log"] for d in got for e in decode_events(d)] == [
        "keep me"]


def test_parsers_and_streams_files(tmp_path):
    """parsers_file and streams_file in [SERVICE] (relative to the
    config) and a [STREAM_TASK] section of the config itself, in both
    packages alike."""
    (tmp_path / "streams.conf").write_text(
        "[STREAM_TASK]\n    Name s1\n    Exec SELECT * FROM TAG:'t';\n")
    conf = tmp_path / "c.conf"
    conf.write_text(f"""
[SERVICE]
    Parsers_File {CONF}/parsers.conf
    Streams_File streams.conf

[STREAM_TASK]
    Name s2
    Exec CREATE STREAM c WITH (tag='c.out') AS SELECT COUNT(*) FROM TAG:'t';

[INPUT]
    Name lib

[OUTPUT]
    Name null
    Match *
""")
    got = flb.create(device="cpu")
    tcf.apply_to_context(got, tcf.load_config_file(str(conf)), str(tmp_path))
    want = ref.create()
    jcf.apply_to_context(want, jcf.load_config_file(str(conf)),
                         str(tmp_path))
    assert sorted(got.engine.parsers) == sorted(want.engine.parsers) == [
        "apache2", "json", "logfmt"]
    for name in ("apache2", "json", "logfmt"):
        p, q = got.engine.parsers[name], want.engine.parsers[name]
        assert (p.fmt, p.time_key, p.time_format, sorted(p.types)) == (
            q.fmt, q.time_key, q.time_format, sorted(q.types))
    assert [(t.sql, t.out_tag) for t in got.engine.sp.tasks] == [
        (t.sql, t.out_tag) for t in want.engine.sp.tasks]
    assert len(got.engine.sp.tasks) == 2
    with pytest.raises(ValueError, match="without Exec"):
        tcf.apply_to_context(flb.create(device="cpu"), tcf.parse_classic(
            "[STREAM_TASK]\n Name x\n"))


UNPORTED = [
    ("[PLUGINS]\n    Path /x.so\n", "DSO"),
    ("[SERVICE]\n    Plugins_File plugins.conf\n", "DSO"),
    ("[MULTILINE_PARSER]\n    Name ml\n    Type regex\n", "multiline"),
    ("[CUSTOM]\n    Name calyptia\n", "custom plugins are not ported"),
    ("[SERVICE]\n    tpu.enable off\n", "'tpu.enable' is not ported"),
    ("[SERVICE]\n    HTTP_Server On\n", "'http_server' is not ported"),
    ("[SERVICE]\n    Log_Level debug\n", "'log_level' is not ported"),
    ("[SERVICE]\n    qos.enable off\n", "'qos.enable' is not ported"),
    ("[SERVICE]\n    Nope 1\n", "unknown service property 'nope'"),
    ("[FOO]\n    Name x\n", r"unknown config section \[foo\]"),
    ("[INPUT]\n    Tag x\n", "without Name"),
    ("[INPUT]\n    Name nope\n", "nope"),
]


@pytest.mark.parametrize("text,word", UNPORTED)
def test_unported_sections_and_service_keys_raise_by_name(text, word):
    ctx = flb.create(device="cpu")
    with pytest.raises((ValueError, KeyError), match=word):
        tcf.apply_to_context(ctx, tcf.parse_classic(text))


@pytest.mark.parametrize("key,value,word", [
    ("tenant", "a", "qos plane"),
    ("net.max_worker_connections", "4", "connection pools"),
    ("tls.ca_file", "/x", "TLS"),
    ("tls", "on", "TLS"),
    ("tls.verify", "off", "TLS"),
    ("tenant.weight", "2", "qos plane"),
    ("proxy", "http://p:3128", "HTTP proxy outputs"),
    ("http2", "on", "HTTP/2 outputs"),
    ("net.keepalive", "on", "connection pools"),
    ("port", "1", "unknown property 'port'"),
])
def test_unported_instance_keys_raise_by_name(key, value, word):
    ctx = flb.create(device="cpu")
    ctx.input("dummy", **{key: value})
    with pytest.raises(ValueError, match=word):
        ctx.start()


STORAGE_INPUT_KEYS = [
    ("Mem_Buf_Limit", "5M"), ("storage.type", "filesystem"),
    ("storage.type", "memrb"), ("storage.pause_on_chunks_overlimit", "on"),
    ("Threaded", "on")]


@pytest.mark.parametrize("key,value", STORAGE_INPUT_KEYS)
def test_storage_input_keys_load_as_in_the_reference(key, value, tmp_path):
    """The buffer and storage keys of an input (refused before the port
    had storage), and the service's five ``storage.*`` keys, from a
    classic config, set what the reference's set."""
    conf = tmp_path / "s.conf"
    conf.write_text(f"""
[SERVICE]
    storage.path              {tmp_path / "st"}
    storage.sync              full
    storage.checksum          on
    storage.backlog.mem_limit 2M
    storage.max_chunks_up     16

[INPUT]
    Name  dummy
    Tag   t
    {key} {value}
""")
    got, want = flb.create(device="cpu"), ref.create()
    tcf.apply_to_context(got, tcf.load_config_file(str(conf)), str(tmp_path))
    jcf.apply_to_context(want, jcf.load_config_file(str(conf)),
                         str(tmp_path))
    for attr in ("storage_path", "storage_sync", "storage_checksum",
                 "storage_backlog_mem_limit", "storage_max_chunks_up"):
        assert getattr(got.service, attr) == getattr(want.service, attr)
    a, b = got.engine.inputs[0], want.engine.inputs[0]
    a.configure()
    b.configure()
    for attr in ("mem_buf_limit", "storage_type",
                 "pause_on_chunks_overlimit", "threaded"):
        assert getattr(a, attr) == getattr(b, attr), attr


def test_delivery_keys_load_as_in_the_reference(tmp_path):
    """The service's retry keys and an output's retry, worker and
    routing keys, from a classic config, set what the reference's do."""
    conf = tmp_path / "d.conf"
    conf.write_text("""
[SERVICE]
    Flush          0.05
    scheduler.base 3
    scheduler.cap  30
    Retry_Limit    4
    task_map_size  16

[INPUT]
    Name  lib
    Tag   t

[OUTPUT]
    Name             null
    Match            t
    Retry_Limit      no_limits
    Workers          2
    route_condition  $level eq error
    route_condition  $code gte 500

[OUTPUT]
    Name          null
    Match         t
    Retry_Limit   2
    no_multiplex  on
""")
    got = []
    for pkg, cf in ((ref, jcf), (flb, tcf)):
        ctx = pkg.create(device="cpu") if pkg is flb else pkg.create()
        cf.apply_to_context(ctx, cf.load_config_file(str(conf)),
                            str(tmp_path))
        svc = ctx.engine.service
        outs = ctx.engine.outputs
        for o in outs:
            o.configure()
        rules = [[(r.ra.pattern, r.op, r.value)
                  for r in o.route_condition.rules]
                 if o.route_condition is not None else None for o in outs]
        got.append((svc.scheduler_base, svc.scheduler_cap, svc.retry_limit,
                    svc.task_map_size,
                    [(o.retry_limit, o.workers,
                      getattr(o.flush_semaphore, "_value", None))
                     for o in outs], rules))
    assert got[0] == got[1]
    assert got[1] == (3.0, 30.0, 4, 16, [(-1, 2, 2), (2, 0, 1)], [
        [("$level", "eq", "error"), ("$code", "gte", 500)], None])


def test_yaml_processors_raise_by_name():
    cf = tcf.parse_yaml("""
pipeline:
  inputs:
    - name: dummy
      processors:
        logs:
          - name: content_modifier
            action: insert
            key: a
            value: b
""")
    with pytest.raises(ValueError, match="processors are not ported"):
        tcf.apply_to_context(flb.create(device="cpu"), cf)
    cf = tcf.parse_yaml("plugins:\n  - /x.so\n")
    with pytest.raises(ValueError, match="DSO"):
        tcf.apply_to_context(flb.create(device="cpu"), cf)
    cf = tcf.parse_yaml("multiline_parsers:\n  - name: ml\n")
    with pytest.raises(ValueError, match="multiline"):
        tcf.apply_to_context(flb.create(device="cpu"), cf)


def test_yaml_without_pyyaml_raises_by_name(monkeypatch):
    """``yaml`` is imported only to read a YAML file; without PyYAML (as
    on a host that lacks it) that raises, and a classic file still
    loads."""
    monkeypatch.setitem(sys.modules, "yaml", None)
    with pytest.raises(ValueError, match="needs PyYAML"):
        tcf.load_config_file(os.path.join(CONF, "baseline4-metrics.yaml"))
    cf = tcf.load_config_file(os.path.join(CONF, "baseline5-k8s.conf"))
    assert [s.name for s in cf.sections][:2] == ["service", "input"]


def test_loader_imports_no_yaml():
    import subprocess

    code = ("import sys, fluentbit_tpu_torch.config_format as c, os\n"
            f"c.load_config_file(os.path.join({CONF!r}, "
            "'baseline5-k8s.conf'))\n"
            "print('yaml' in sys.modules)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "False"
