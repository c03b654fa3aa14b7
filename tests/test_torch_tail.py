"""in_tail through the port against the reference package.

Each scenario writes files under one directory, runs the reference's
``tail`` and then the port's (stat polling) over the same paths through
the lib APIs, and changes the files while they run: both must hand the
lib output the same records — tags and bodies in order — and those must
equal the lines the scenario wrote. The records' times are the read's
``now`` in both packages, so they are not compared. The properties the
port leaves out raise.
"""

import os
import shutil
import time

import pytest

import fluentbit_tpu
import fluentbit_tpu_torch
from fluentbit_tpu.codec.events import decode_events as jax_decode_events
from fluentbit_tpu_torch.codec.events import decode_events

TICK = 0.02  # both tails' collector interval here (0.25 s by default)


def write(path, data, mode="ab"):
    with open(path, mode) as fh:
        fh.write(data)


def wait_for(cond, what, timeout=10.0):
    deadline = time.time() + timeout
    while not cond():
        if time.time() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(TICK)


def run_tail(create, decode, root, setup, steps, props, parsers=None,
             times=False, **create_kw):
    """Fresh ``root``, ``setup(root)``, a tail over it → lib output; each
    step is (action, records expected after it). ``parsers`` maps names
    to [PARSER] properties to register first. Returns [(tag, body)], or
    [(tag, body, time)] with ``times``."""
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    setup(root)
    got = []
    ctx = create(flush="20ms", grace="1", **create_kw)
    for name, pprops in (parsers or {}).items():
        ctx.parser(name, **pprops)
    ffd = ctx.input("tail", **{k: v.format(root=root)
                               for k, v in props.items()})
    tail = ctx._handles[ffd].plugin
    tail.collect_interval = TICK
    ctx.output("lib", match="*", callback=lambda d, t: got.extend(
        (t, ev.body, ev.timestamp) if times else (t, ev.body)
        for ev in decode(d)))
    ctx.start()
    try:
        for action, n in steps:
            if action == "scanned":  # the first scan has taken the files
                wait_for(lambda: tail._files, "the first scan")
                continue
            if action is not None:
                action(root)
            wait_for(lambda: (ctx.flush_now(), len(got) >= n)[1],
                     f"{n} records (have {len(got)})")
    finally:
        ctx.stop()
    return got


def head_partial_crlf_blank(root):
    write(f"{root}/a.log", b"alpha\r\nbeta\n\n\r\ngamma\npart")


def rotate(root):
    write(f"{root}/a.log", b"r3\n")
    os.rename(f"{root}/a.log", f"{root}/a.log.1")
    write(f"{root}/a.log", b"n1\nn2\n")


SCENARIOS = {
    # read_from_head, a partial last line completed later, CRLF and
    # blank lines
    "head_partial_crlf_blank": (
        head_partial_crlf_blank,
        [(None, 3), (lambda r: write(f"{r}/a.log", b"ial\nomega\n"), 5)],
        {"path": "{root}/a.log", "tag": "t", "read_from_head": "true"},
        [("t", {"log": x}) for x in
         ("alpha", "beta", "gamma", "partial", "omega")]),
    # without read_from_head the content present at start is skipped
    # (stat polling in both: the reference's inotify watch is added just
    # after the scan this step waits for)
    "tail_from_end": (
        lambda r: write(f"{r}/a.log", b"old1\nold2\n"),
        [("scanned", 0), (lambda r: write(f"{r}/a.log", b"new1\n"), 1)],
        {"path": "{root}/a.log", "tag": "t", "inotify_watcher": "off"},
        [("t", {"log": "new1"})]),
    # lines above buffer_max_size are dropped, whole or split by reads
    "skip_long_lines": (
        lambda r: write(f"{r}/a.log",
                        b"short\n" + b"x" * 40 + b"\nafter\n" + b"y" * 40),
        [(None, 2), (lambda r: write(f"{r}/a.log", b"yyy\nlast\n"), 3)],
        {"path": "{root}/a.log", "tag": "t", "read_from_head": "on",
         "buffer_max_size": "16", "skip_long_lines": "on"},
        [("t", {"log": x}) for x in ("short", "after", "last")]),
    # a glob less exclude_path, `*` in the tag, path_key, a custom key
    "glob_tag_path_key": (
        lambda r: [write(f"{r}/{n}", f"{n} line\n".encode())
                   for n in ("a.log", "b.log", "skip.log", "c.txt")],
        [(None, 2)],
        {"path": "{root}/*.log", "exclude_path": "{root}/skip.log",
         "tag": "tail.*", "path_key": "file", "key": "msg",
         "read_from_head": "true"},
        None),
    # truncation: the file shrank under the same inode, read from 0
    "truncation": (
        lambda r: write(f"{r}/a.log", b"one\ntwo\n"),
        [(None, 2), (lambda r: write(f"{r}/a.log", b"z\n", "wb"), 3)],
        {"path": "{root}/a.log", "tag": "t", "read_from_head": "true"},
        [("t", {"log": x}) for x in ("one", "two", "z")]),
    # rotation: the old file is drained, then the new one read from 0
    "rotation": (
        lambda r: write(f"{r}/a.log", b"r1\nr2\n"),
        [(None, 2), (rotate, 5)],
        {"path": "{root}/a.log", "tag": "t", "read_from_head": "true",
         "refresh_interval": "0.05"},
        [("t", {"log": x}) for x in ("r1", "r2", "r3", "n1", "n2")]),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_port_tail_equals_reference(tmp_path, name):
    setup, steps, props, want = SCENARIOS[name]
    root = str(tmp_path / "logs")
    ref = run_tail(fluentbit_tpu.create, jax_decode_events, root, setup,
                   steps, props)
    got = run_tail(fluentbit_tpu_torch.create, decode_events, root, setup,
                   steps, props, device="cpu")
    assert got == ref
    if want is None:  # glob_tag_path_key
        dotted = root.lstrip("/").replace("/", ".")
        want = [(f"tail.{dotted}.{n}", {"msg": f"{n} line",
                                        "file": f"{root}/{n}"})
                for n in ("a.log", "b.log")]
    assert got == want


def test_invalid_utf8_is_replaced(tmp_path):
    path = tmp_path / "a.log"
    write(path, b"ok \xff\xfe bytes\nfine\n")
    got = run_tail(fluentbit_tpu_torch.create, decode_events,
                   str(tmp_path / "d"),
                   lambda r: shutil.copy(path, f"{r}/a.log"), [(None, 2)],
                   {"path": "{root}/a.log", "tag": "t",
                    "read_from_head": "true"}, device="cpu")
    assert got == [("t", {"log": "ok �� bytes"}),
                   ("t", {"log": "fine"})]


PARSERS = {
    "json": dict(Format="json", Time_Key="time",
                 Time_Format="%d/%b/%Y:%H:%M:%S %z"),
    "kv": dict(Format="regex", Regex=r"^(?<k>[a-z]+)=(?<v>\d+) (?<t>.*)$",
               Time_Key="t", Time_Format="%Y-%m-%d %H:%M:%S",
               Types="v:integer"),
}
PARSED_LINES = (
    b'{"time": "10/Oct/2000:13:55:36 -0700", "a": "\xc3\xa9"}\n'
    b'{"time": "bad", "b": [1, 2.5]}\n'
    b'not json\n[1, 2]\n{"c": null}\r\n'
    b'x=1 2024-01-02 03:04:05\nx=y 2024-01-02 03:04:05\ny=7 nope\n')


@pytest.mark.parametrize("parser", sorted(PARSERS))
def test_parser_option_equals_reference(tmp_path, parser):
    """``parser``: parsed lines become the parsed fields stamped with the
    parsed time; refused lines stay ``{log: line}``."""
    root = str(tmp_path / "logs")
    args = (root, lambda r: write(f"{r}/a.log", PARSED_LINES), [(None, 8)],
            {"path": "{root}/a.log", "tag": "t", "read_from_head": "true",
             "parser": parser})
    ref = run_tail(fluentbit_tpu.create, jax_decode_events, *args,
                   parsers=PARSERS, times=True)
    got = run_tail(fluentbit_tpu_torch.create, decode_events, *args,
                   parsers=PARSERS, times=True, device="cpu")
    assert [(t, b) for t, b, _ in got] == [(t, b) for t, b, _ in ref]
    stamped = [(i, ts) for i, (_, _, ts) in enumerate(got)
               if isinstance(ts, float)]
    assert stamped == [(i, ts) for i, (_, _, ts) in enumerate(ref)
                       if isinstance(ts, float)]
    assert len(stamped) == 1
    assert sum("log" in b for _, b, _ in got) == (6 if parser == "kv" else 5)


@pytest.mark.parametrize("prop,value", [
    # "parser" is ported: a name no parser was registered under raises
    ("db", "tail.db"), ("parser", "json"), ("multiline.parser", "docker"),
    ("unicode.encoding", "UTF-16LE"), ("generic.encoding", "ShiftJIS")])
def test_left_out_properties_raise(tmp_path, prop, value):
    ctx = fluentbit_tpu_torch.create(device="cpu")
    ctx.input("tail", path=str(tmp_path / "*.log"), **{prop: value})
    with pytest.raises(ValueError, match=prop.replace(".", r"\.")):
        ctx.start()
