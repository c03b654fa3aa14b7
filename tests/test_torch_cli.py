"""The port's CLI (``python -m fluentbit_tpu_torch``) and supervisor.

``build_context`` against the reference's for the same argv (the port's
given ``--device cpu`` as well), ``--dry-run``, every option that is not
ported raising by name, and no silent CPU run without a card. Then the
CLI as a subprocess on ``--device cpu``, each wait on a log line, never a
fixed sleep: an aggregator (forward input → grep Exclude → file) fed by
the port's forward output, SIGHUP ignored with ``hot_reload`` off and
SIGTERM ending it with exit 0 after the last flush; one full-restart
reload on SIGHUP with ``hot_reload`` on; ``--supervisor`` restarting a
killed worker, and ending at once on a fast startup failure. Last, the
two-tier example configs (``conf/relay5-*.conf``) load as in the
reference.
"""

import json
import os
import queue
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest
import torch

import fluentbit_tpu.__main__ as rcli
import fluentbit_tpu_torch.__main__ as tcli
from fluentbit_tpu_torch.codec.events import encode_event

REPO = Path(__file__).resolve().parents[1]


def instances(ctx) -> list:
    eng = ctx.engine
    return [(kind, i.plugin.name, i.properties.items())
            for kind, group in (("input", eng.inputs),
                                ("filter", eng.filters),
                                ("output", eng.outputs))
            for i in group]


def service(ctx) -> tuple:
    s = ctx.engine.service
    return (s.flush, s.grace, s.hot_reload, s.retry_limit)


def argvs(tmp_path) -> list:
    conf = tmp_path / "a.conf"
    conf.write_text(
        "[SERVICE]\n    Flush 2\n    Grace 3\n    Hot_Reload On\n\n"
        "[INPUT]\n    Name dummy\n    Tag ${TAG}\n    Rate 3\n\n"
        "[FILTER]\n    Name grep\n    Match ${TAG}\n"
        "    Exclude message x\n\n"
        "[OUTPUT]\n    Name null\n    Match *\n")
    parsers = tmp_path / "p.conf"
    parsers.write_text("[PARSER]\n    Name p1\n    Format json\n"
                       "    Time_Key t\n")
    return [
        ["-i", "dummy", "-p", "rate=5", "-p", "samples=3", "-t", "app",
         "-F", "grep", "-p", "regex=message d", "-m", "app",
         "-o", "stdout", "-m", "*", "-p", "format=json_lines",
         "-f", "0.5", "-g", "2", "-v", "-v", "-q", "--dry-run"],
        ["-D", "TAG=from.define", "-c", str(conf), "-o", "lib",
         "-p", "match=from.*"],
        ["-R", str(parsers), "-i", "lib", "--input", "dummy",
         "--tag", "t2", "--output", "null", "--match", "t2", "--flush",
         "1", "-D", "A=B"],
    ]


def test_build_context_equals_reference(tmp_path):
    """The same argv builds the same pipeline: instances in order with
    their properties, service values, verbosity, dry-run, the config
    path and the -D variables; the parsers a -R file registers."""
    for argv in argvs(tmp_path):
        got = tcli.build_context(["--device", "cpu"] + argv)
        want = rcli.build_context(argv)
        assert instances(got[0]) == instances(want[0])
        assert service(got[0]) == service(want[0])
        assert got[1:] == want[1:]
        assert sorted(got[0].engine.parsers) == sorted(
            want[0].engine.parsers)
        assert got[0].device.type == "cpu"
    # the port's context is on the device --device names (last wins)
    ctx = tcli.build_context(["--device", "cuda", "--device", "cpu",
                              "-i", "dummy", "-o", "null"])[0]
    assert ctx.device.type == "cpu"


@pytest.mark.parametrize("argv,word", [
    (["-e", "x.so"], "option -e is not ported: the port has no dynamic"),
    (["--plugin", "x.so"], "option --plugin is not ported"),
    (["-H"], "option -H is not ported: the port has no admin HTTP"),
    (["--http"], "option --http is not ported"),
    (["-P", "2021"], "option -P is not ported"),
    (["--port", "2021"], "option --port is not ported"),
    (["--device", "tpu"], "--device takes one of"),
    (["-p", "a=b"], "bad -p usage"),
    (["-i", "dummy", "-m", "x"], "-m requires a preceding -F/-o"),
    (["--nope"], "unknown option '--nope'"),
])
def test_unported_and_bad_options_raise_by_name(argv, word):
    with pytest.raises(SystemExit, match=word):
        tcli.build_context(["--device", "cpu"] + argv)


@pytest.mark.parametrize("line,word", [
    ("HTTP_Server On", "'http_server' is not ported"),
    ("HTTP_Port 2021", "'http_port' is not ported"),
    ("Hot_Reload_Diff On", "'hot_reload_diff' is not ported"),
    ("qos.enable On", "'qos.enable' is not ported"),
])
def test_unported_service_keys_in_a_config_raise(tmp_path, line, word):
    conf = tmp_path / "s.conf"
    conf.write_text(f"[SERVICE]\n    {line}\n")
    with pytest.raises(ValueError, match=word):
        tcli.build_context(["--device", "cpu", "-c", str(conf)])


def test_no_card_raises_unless_cpu_is_asked_for(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.build_context(["-i", "dummy", "-o", "null"])
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.main(["-i", "dummy", "-o", "null", "--dry-run"])
    argv = ["-i", "dummy", "-o", "null", "--dry-run"]
    assert tcli.main(["--device", "cpu"] + argv) == rcli.main(argv) == 0
    assert capsys.readouterr().out.count(
        "configuration test is successful") == 2
    assert tcli.main(["--device", "cpu", "-i", "dummy",
                      "--dry-run"]) == rcli.main(["-i", "dummy"]) == 1
    assert tcli.main([]) == 1
    with pytest.raises(SystemExit):
        tcli.main(["--version"])
    assert "fluentbit_tpu_torch v" in capsys.readouterr().out


class Cli:
    """The CLI as a subprocess; its stderr lines, read on a thread."""

    def __init__(self, *argv):
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "fluentbit_tpu_torch", *argv],
            cwd=REPO, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
            text=True)
        self.lines: list = []
        self._q: queue.Queue = queue.Queue()
        threading.Thread(target=self._read, daemon=True).start()

    def _read(self):
        for line in self.proc.stderr:
            self._q.put(line)

    def wait_line(self, word, count=1, timeout=60.0) -> str:
        """Block until ``count`` lines hold ``word``; return the last."""
        deadline = time.time() + timeout
        while True:
            hits = [ln for ln in self.lines if word in ln]
            if len(hits) >= count:
                return hits[count - 1]
            remaining = deadline - time.time()
            if remaining <= 0:
                raise TimeoutError(f"{word!r} x{count}: {self.lines}")
            try:
                self.lines.append(self._q.get(timeout=remaining))
            except queue.Empty:
                pass

    def signal(self, sig) -> None:
        self.proc.send_signal(sig)

    def finish(self, timeout=60.0) -> int:
        rc = self.proc.wait(timeout=timeout)
        while True:
            try:
                self.lines.append(self._q.get(timeout=1.0))
            except queue.Empty:
                return rc

    def kill(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


@pytest.fixture
def cli_procs():
    procs = []
    yield procs
    for p in procs:
        p.kill()


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


AGG_CONF = """\
[SERVICE]
    Flush      0.1
    Grace      2
    Hot_Reload {hot}

[INPUT]
    Name       forward
    Listen     127.0.0.1
    Port       {port}

[FILTER]
    Name       grep
    Match      *
    Exclude    log DROP

[OUTPUT]
    Name       file
    Match      *
    Path       {out}
    File       records.log
    Format     plain
"""


def test_cli_aggregator_sighup_ignored_sigterm_exits_zero(tmp_path,
                                                          cli_procs):
    """A CLI aggregator fed by the port's forward output with acks: its
    file holds the kept records; SIGHUP with hot_reload off is ignored
    with a warning (the pipeline keeps running); SIGTERM stops it after
    the last flush with exit code 0."""
    import fluentbit_tpu_torch as flb

    port = free_port()
    conf = tmp_path / "agg.conf"
    conf.write_text(AGG_CONF.format(hot="Off", port=port, out=tmp_path))
    cli = Cli("--device", "cpu", "-c", str(conf))
    cli_procs.append(cli)
    assert "on cpu" in cli.wait_line("started")
    recs = [{"log": f"{i} {'DROP' if i % 5 == 0 else 'keep'}", "i": i}
            for i in range(200)]
    edge = flb.create(device="cpu", flush="50ms", grace="1")
    edge.input("lib", tag="edge")
    edge.output("forward", match="*", port=str(port),
                require_ack_response="on")
    edge.start()
    try:
        ins = edge.engine.inputs[0]
        for k in range(0, 200, 50):
            data = b"".join(encode_event(r, 1700000000 + r["i"])
                            for r in recs[k:k + 50])
            edge.engine.input_log_append(ins, "app", data, 50)
        edge.flush_now()
    finally:
        edge.stop()
    assert edge.engine.outputs[0].plugin.n_acks_waited >= 1
    cli.signal(signal.SIGHUP)
    cli.wait_line("SIGHUP ignored")
    assert cli.proc.poll() is None
    cli.signal(signal.SIGTERM)
    assert cli.finish() == 0
    assert any("stopping (grace" in ln for ln in cli.lines)
    rows = [json.loads(ln) for ln in
            (tmp_path / "records.log").read_text().splitlines()]
    assert rows == [r for r in recs if "DROP" not in r["log"]]


def test_cli_sighup_reloads_with_hot_reload_on(tmp_path, cli_procs):
    """With hot_reload on, SIGHUP validates the command line again and
    restarts the pipeline once; SIGTERM then exits 0."""
    conf = tmp_path / "agg.conf"
    conf.write_text(AGG_CONF.format(hot="On", port=free_port(),
                                    out=tmp_path))
    cli = Cli("--device", "cpu", "-c", str(conf))
    cli_procs.append(cli)
    cli.wait_line("started")
    cli.signal(signal.SIGHUP)
    cli.wait_line("reloading configuration")
    cli.wait_line("started", count=2)
    cli.signal(signal.SIGTERM)
    assert cli.finish() == 0
    assert sum("stopping old pipeline" in ln for ln in cli.lines) == 1
    assert sum("started" in ln for ln in cli.lines) == 2


def test_supervisor_restarts_a_killed_worker(tmp_path, cli_procs):
    """``--supervisor``: a worker killed by a signal is restarted after
    the backoff; SIGTERM to the supervisor stops the worker and ends
    with its exit code 0."""
    conf = tmp_path / "agg.conf"
    conf.write_text(AGG_CONF.format(hot="Off", port=free_port(),
                                    out=tmp_path))
    cli = Cli("--supervisor", "--device", "cpu", "-c", str(conf))
    cli_procs.append(cli)
    first = int(cli.wait_line("worker started (pid").split("pid ")[1]
                .split(")")[0])
    cli.wait_line("v0.1.0 started")
    os.kill(first, signal.SIGKILL)
    cli.wait_line("worker died (signal 9); restart #1")
    second = int(cli.wait_line("worker started (pid", count=2)
                 .split("pid ")[1].split(")")[0])
    assert second != first
    cli.wait_line("v0.1.0 started", count=2)
    cli.signal(signal.SIGTERM)
    assert cli.finish() == 0
    assert any("worker exited (0)" in ln for ln in cli.lines)


def test_supervisor_fast_startup_failure_is_terminal(cli_procs):
    """A worker that fails at startup (an unknown plugin) is not
    restarted: the supervisor ends with its exit code."""
    cli = Cli("--supervisor", "--device", "cpu", "-i", "nope", "-o", "null")
    cli_procs.append(cli)
    assert cli.finish() == 1
    text = "".join(cli.lines)
    assert "unknown input plugin 'nope'" in text
    assert "failed at startup" in text and "restart #" not in text


def test_relay5_example_configs_load_as_in_the_reference(tmp_path):
    """conf/relay5-edge.conf and conf/relay5-aggregator.conf, with their
    -D variables, build the same pipelines in both packages, and the
    edge's upstream file gives the same node set."""
    from fluentbit_tpu.core.upstream import parse_upstream_file as rparse
    from fluentbit_tpu_torch.core.upstream import parse_upstream_file

    up = str(REPO / "conf" / "relay5-upstream.conf")
    defines = ["-D", f"RELAY_UPSTREAM={up}", "-D", "RELAY_SHARED_KEY=k",
               "-D", "RELAY_CA_FILE=ca.pem", "-D", "RELAY_CRT_FILE=c.pem",
               "-D", "RELAY_KEY_FILE=c.key",
               "-D", f"SPOOL_DIR={tmp_path / 'spool'}"]
    for name in ("relay5-edge.conf", "relay5-aggregator.conf"):
        argv = defines + ["-c", str(REPO / "conf" / name), "--dry-run"]
        got = tcli.build_context(["--device", "cpu"] + argv)
        want = rcli.build_context(argv)
        assert instances(got[0]) == instances(want[0])
        assert service(got[0]) == service(want[0])
    edge = instances(tcli.build_context(
        ["--device", "cpu"] + defines
        + ["-c", str(REPO / "conf" / "relay5-edge.conf")])[0])
    assert dict(edge[-1][2])["Upstream"] == up
    a, b = parse_upstream_file(up), rparse(up)
    assert [(n.name, n.host, n.port, n.weight) for n in a.nodes] == [
        (n.name, n.host, n.port, n.weight) for n in b.nodes] == [
        ("agg-1", "127.0.0.1", 24225, 1)]
