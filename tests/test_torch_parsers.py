"""The port's parsers, strptime and ``FlbRegex.parse_record`` against the
reference package's.

The same inputs (fixed lists plus lines made from a seed) go through
``fluentbit_tpu.parsers`` and ``fluentbit_tpu_torch.parsers``: every
``Parser.do`` result (fields and time), ``time_lookup``,
``parse_tzone_offset`` and named-capture extraction must be equal
(exact: parsed values are strings, ints and floats computed the same
way).
"""

import json
import random

import pytest

from fluentbit_tpu import parsers as jp
from fluentbit_tpu.parsers import strptime as jst
from fluentbit_tpu.regex import FlbRegex as JaxFlbRegex
from fluentbit_tpu_torch import parsers as tp
from fluentbit_tpu_torch.parsers import strptime as tst
from fluentbit_tpu_torch.regex import FlbRegex

APACHE2 = (
    r'^(?<host>[^ ]*) [^ ]* (?<user>[^ ]*) \[(?<time>[^\]]*)\] '
    r'"(?<method>\S+)(?: +(?<path>[^ ]*) +\S*)?" (?<code>[^ ]*) '
    r'(?<size>[^ ]*)(?: "(?<referer>[^\"]*)" "(?<agent>.*)")?$'
)
#: conf/parsers.conf's apache2 and json parsers, plus a logfmt and an
#: ltsv parser with Types, Time_Keep and a Time_Offset
PARSERS = {
    "apache2": dict(Format="regex", Regex=APACHE2, Time_Key="time",
                    Time_Format="%d/%b/%Y:%H:%M:%S %z",
                    Types="code:integer size:integer"),
    "json": dict(Format="json", Time_Key="time",
                 Time_Format="%d/%b/%Y:%H:%M:%S %z"),
    "logfmt": dict(Format="logfmt", Types="n:integer f:float ok:bool "
                   "h:hex", Time_Key="ts",
                   Time_Format="%Y-%m-%dT%H:%M:%S.%L%z", Time_Keep="on"),
    "ltsv": dict(Format="ltsv", Types="status:integer", Time_Key="time",
                 Time_Format="%Y-%m-%d %H:%M:%S", Time_Offset="+0900",
                 Skip_Empty_Values="off"),
}


def lines(seed, n=60):
    """Lines for every parser: matching and broken ones of each format."""
    rng = random.Random(seed)
    out = []
    for i in range(n):
        day = rng.randrange(1, 29)
        t = f"{day:02d}/Oct/2000:13:{i % 60:02d}:36 -0700"
        out += [
            f'10.0.0.{i} - u{i} [{t}] "GET /p/ü{i} HTTP/1.1" 200 {i * 7}',
            f'10.0.0.{i} - - [{t}] "POST /x HTTP/1.0" 5{i % 10}x - '
            f'"http://r/{i}" "curl 日本"',
            f'10.0.0.{i} - u [99/Oct/2000:13:55:36 -0700] "GET /" 200 1',
            json.dumps({"time": t, "level": "info", "n": i,
                        "msg": "é🎉" * (i % 3), "nested": {"a": [1, 2.5]}}),
            json.dumps({"time": "not a time", "v": i}),
            json.dumps([i, "array"]),
            "{not json",
            f'n={i} f={i / 4} ok={"yes" if i % 2 else "off"} h=ff msg="a '
            f'\\"q\\" {i}" ts=2024-01-0{1 + i % 9}T10:00:0{i % 10}.'
            f'{i:03d}+0100 bare',
            f"status:{200 + i}\ttime:2024-02-03 04:05:{i % 60:02d}\t"
            f"empty:\tpath:/a/{i}",
            f"status:x{i}\ttime:bad\n",
            "",
        ]
    return out


def both(name):
    return (jp.create_parser(name, **PARSERS[name]),
            tp.create_parser(name, **PARSERS[name]))


@pytest.mark.parametrize("name", sorted(PARSERS))
@pytest.mark.parametrize("seed", [0, 1])
def test_parser_do_equals_reference(name, seed):
    ref, port = both(name)
    assert port.fmt == ref.fmt and port.types.keys() == ref.types.keys()
    parsed = 0
    for text in lines(seed):
        want = ref.do(text)
        got = port.do(text)
        assert got == want, (name, text)
        if want is not None:
            # bools, ints and floats keep their types
            assert json.dumps(got[0]) == json.dumps(want[0])
            parsed += 1
    assert parsed > 0


def test_apache2_types_and_time():
    _, port = both("apache2")
    fields, ts = port.do('1.2.3.4 - bob [10/Oct/2000:13:55:36 -0700] '
                         '"GET /i.gif HTTP/1.0" 200 99 "r" "a"')
    assert fields == {"host": "1.2.3.4", "user": "bob", "method": "GET",
                      "path": "/i.gif", "code": 200, "size": 99,
                      "referer": "r", "agent": "a"}
    assert ts == 971211336


NOW = 1_700_000_000.0  # 2023-11-14T22:13:20Z


@pytest.mark.parametrize("fmt,values", [
    ("%d/%b/%Y:%H:%M:%S %z", ["10/Oct/2000:13:55:36 -0700",
                              "01/January/2024:00:00:00 +0530",
                              "32/Oct/2000:13:55:36 -0700", "junk"]),
    ("%Y-%m-%dT%H:%M:%S.%L%z", ["2024-01-02T03:04:05.123+0100",
                                "2024-01-02T03:04:05,5Z",
                                "2024-01-02T03:04:05Z"]),
    ("%s", ["1700000000", "0", "x"]),
    ("%b %d %H:%M:%S", ["Oct 17 15:12:32", "Feb  3 01:02:03", "Foo 1 1"]),
])
def test_time_lookup_equals_reference(fmt, values):
    for v in values:
        for offset in (0, 3600, -19800):
            want = jst.time_lookup(v, fmt, offset, now=NOW)
            got = tst.time_lookup(v, fmt, offset, now=NOW)
            assert got == want, (fmt, v, offset)


def test_yearless_format_takes_the_year_of_now():
    got = tst.time_lookup("Jan 01 00:00:00", "%b %d %H:%M:%S", now=NOW)
    assert got == 1_672_531_200.0  # 2023-01-01T00:00:00Z


@pytest.mark.parametrize("text", ["+0200", "-05:30", "Z", "z", " +0100 ",
                                  "0200", "", "+xx"])
def test_parse_tzone_offset_equals_reference(text):
    assert tst.parse_tzone_offset(text) == jst.parse_tzone_offset(text)


@pytest.mark.parametrize("pattern", [
    APACHE2,
    r"^(?<k>\w+)=(?<v>[^ ]*)(?: (?<rest>.*))?$",
    r"(?<a>x)|(?<b>y)",
])
def test_parse_record_equals_reference(pattern):
    texts = ["k=v tail", "k= ", "x", "y", "nothing", "ü=ü more",
             b"k=\xff\xfe raw", "10.0.0.1 - - [t] \"GET / HTTP/1.1\" 200 3"]
    texts += lines(2, 5)
    ref, port = JaxFlbRegex(pattern), FlbRegex(pattern)
    for text in texts:
        assert port.parse_record(text) == ref.parse_record(text), text


def test_unknown_format_and_bad_types_raise():
    with pytest.raises(tp.ParserError):
        tp.create_parser("x", Format="yaml")
    with pytest.raises(tp.ParserError):
        tp.create_parser("x", Format="json", Types="a:nope")
    with pytest.raises(tp.ParserError):
        tp.create_parser("x", Format="regex")
