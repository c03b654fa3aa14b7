"""The port's filter_kubernetes, and BASELINE config 5, against the
reference's.

Each case runs the same records through the reference package
(``fluentbit_tpu``, JAX on the CPU) and the port (``device="cpu"``) and
compares what the ``lib`` output receives, byte for byte. Ported from
the reference's own tests: cache enrichment, merge_log JSON, a tag that
does not match, the exclude annotation
(``tests/test_kubernetes_processors.py``), and the ``kube_url`` fetch
over https with a token file, the CA check, the token command with its
TTL and the retry after a 401 (``tests/test_kube_tls_token.py``, against
a loopback apiserver). Also ``merge_parser``, ``merge_log_key``,
``keep_log off``, ``labels`` / ``annotations off``, the parser
annotation, the tag regex's captures on odd tags (against Python ``re``
too), and config 5 end to end: seeded k8s traffic over loopback forward
connections → kubernetes (Merge_Log On, a preload cache) → grep Exclude
``log health-check`` → lib, where appends of >= 32 records take grep's
device path (on the CPU, the plain DFA walk) and smaller ones the
host regex.
"""

import json
import re
import socket
import ssl
import subprocess
import threading

import numpy as np
import pytest

import fluentbit_tpu as ref
import fluentbit_tpu_torch as flb
from fluentbit_tpu_torch.codec.events import decode_events as tdecode
from fluentbit_tpu_torch.codec.msgpack import EventTime

from test_torch_forward import Client, message, serve
from test_torch_pipeline import push_ordered_bytes

K8S_TAG = ("kube.var.log.containers."
           "web-5c7f9_prod_nginx-0123456789abcdef0123456789abcdef"
           "0123456789abcdef0123456789abcdef.log")


def write_meta(d, namespace="prod", pod="web-5c7f9", **kw):
    meta = {
        "metadata": {
            "uid": "pod-uid-1",
            "labels": {"app": "web"},
            "annotations": kw.get("annotations", {"team": "core"}),
        },
        "spec": {"nodeName": "node-7"},
    }
    d.mkdir(exist_ok=True)
    (d / f"{namespace}_{pod}.meta").write_text(json.dumps(meta))
    return str(d)


def run_lib(create, records, tag, filters, parsers=(), **kw):
    """lib input → the given filters → lib output, each record pushed
    with its own time; returns the bytes received, concatenated."""
    ctx = create(flush="50ms", grace="1", **kw)
    for name, props in parsers:
        ctx.parser(name, **props)
    in_ffd = ctx.input("lib", tag=tag)
    for name, props in filters:
        ctx.filter(name, **props)
    got = []
    ctx.output("lib", match="*", callback=lambda d, t: got.append(bytes(d)))
    ctx.start()
    try:
        for i, r in enumerate(records):
            ctx.push(in_ffd, json.dumps([[1700000000 + i, r]]))
        ctx.flush_now()
    finally:
        ctx.stop()
    return b"".join(got)


def both_lib(records, tag, filters, parsers=()):
    want = run_lib(ref.create, records, tag, filters, parsers)
    got = run_lib(flb.create, records, tag, filters, parsers, device="cpu")
    # one tag, a record a push: the reference's in the order of the
    # pushes (push_ordered), the port's as they came
    assert got == push_ordered_bytes(want)
    return [ev.body for ev in tdecode(got)]


def k8s(cache, **props):
    return [("kubernetes", dict(match="kube.*",
                                kube_meta_preload_cache_dir=cache, **props))]


def test_enrichment_from_cache(tmp_path):
    evs = both_lib([{"log": "hello"}], K8S_TAG, k8s(write_meta(tmp_path)))
    assert evs[0]["kubernetes"] == {
        "pod_name": "web-5c7f9", "namespace_name": "prod",
        "container_name": "nginx",
        "docker_id": "0123456789abcdef" * 4, "pod_id": "pod-uid-1",
        "host": "node-7", "labels": {"app": "web"},
        "annotations": {"team": "core"}}


def test_merge_log_json_and_keep_log(tmp_path):
    cache = write_meta(tmp_path)
    evs = both_lib([{"log": '{"level": "info", "msg": "m"}  \n'},
                    {"log": '{"log": "inner", "a": 1}', "a": 0},
                    {"log": "[1, 2]"}, {"log": "{bad json"}, {"x": 1}],
                   K8S_TAG, k8s(cache, merge_log="on"))
    assert evs[0]["level"] == "info" and "log" in evs[0]
    assert evs[1]["a"] == 0 and evs[1]["log"] == '{"log": "inner", "a": 1}'
    evs = both_lib([{"log": '{"a": 1}'}, {"log": "plain"}], K8S_TAG,
                   k8s(cache, merge_log="on", keep_log="off"))
    assert "log" not in evs[0] and evs[0]["a"] == 1
    assert evs[1]["log"] == "plain"


def test_merge_log_key_trim_off_and_labels_annotations_off(tmp_path):
    cache = write_meta(tmp_path)
    evs = both_lib([{"log": '{"a": {"b": 2}}\n'}], K8S_TAG,
                   k8s(cache, merge_log="on", merge_log_key="app",
                       labels="off", annotations="off"))
    assert evs[0]["app"] == {"a": {"b": 2}}
    assert "labels" not in evs[0]["kubernetes"]
    assert "annotations" not in evs[0]["kubernetes"]
    evs = both_lib([{"log": '{"a": 1}\n'}], K8S_TAG,
                   k8s(cache, merge_log="on", merge_log_trim="off"))
    assert evs[0]["a"] == 1


LOGFMT = ("logfmt", {"Format": "logfmt"})
APACHE = ("apache2", {
    "Format": "regex",
    "Regex": r'^(?<host>[^ ]*) [^ ]* (?<user>[^ ]*) \[(?<time>[^\]]*)\] '
             r'"(?<method>\S+)(?: +(?<path>[^ ]*) +\S*)?" (?<code>[^ ]*) '
             r'(?<size>[^ ]*)$',
    "Time_Key": "time", "Time_Format": "%d/%b/%Y:%H:%M:%S %z",
    "Types": "code:integer size:integer"})


def test_merge_parser_and_parser_annotation(tmp_path):
    line = '10.0.0.1 - u [10/Oct/2000:13:55:36 -0700] "GET /x HTTP/1.1" 200 23'
    evs = both_lib([{"log": line}, {"log": "not apache"}], K8S_TAG,
                   k8s(write_meta(tmp_path / "a"), merge_log="on",
                       merge_parser="apache2"), parsers=[APACHE])
    assert evs[0]["code"] == 200 and evs[0]["method"] == "GET"
    assert "code" not in evs[1]
    cache = write_meta(tmp_path / "b", annotations={
        "fluentbit.io/parser": "logfmt"})
    for gate in ("on", "off"):
        evs = both_lib([{"log": "a=1 b=two"}], K8S_TAG,
                       k8s(cache, merge_log="on",
                           **{"k8s-logging.parser": gate}),
                       parsers=[LOGFMT])
        assert ("b" in evs[0]) == (gate == "on")


def test_non_matching_tag_untouched(tmp_path):
    evs = both_lib([{"log": "x"}], "other.tag", k8s(write_meta(tmp_path)))
    assert evs == [{"log": "x"}]


@pytest.mark.parametrize("gate", ["on", "off"])
def test_exclude_annotation(tmp_path, gate):
    cache = write_meta(tmp_path,
                       annotations={"fluentbit.io/exclude": "true"})
    evs = both_lib([{"log": "x"}], K8S_TAG,
                   k8s(cache, **{"k8s-logging.exclude": gate}))
    assert len(evs) == (0 if gate == "on" else 1)


def test_pod_without_meta_gets_identity_only(tmp_path):
    tag = K8S_TAG.replace("web-5c7f9_prod", "other_prod")
    evs = both_lib([{"log": "x"}], tag, k8s(write_meta(tmp_path)))
    assert evs[0]["kubernetes"] == {
        "pod_name": "other", "namespace_name": "prod",
        "container_name": "nginx", "docker_id": "0123456789abcdef" * 4}


ODD_TAGS = [
    "kube.var.log.containers.web.v2-7f9c_prod_nginx-0123456789ab.log",
    "kube.var.log.containers.a_b_side_car-0123456789abcdef.log",
    "kube.var.log.containers.a_b_c-" + "f" * 64 + ".log",
    "kube.var.log.containers.a_b_c-" + "f" * 65 + ".log",
    "kube.var.log.containers.a_b_c-0123456789a.log",
    "kube.var.log.containers.Web_b_c-0123456789ab.log",
    "kube.var.log.containers.a-_b_c-0123456789ab.log",
    "kube.var.log.containers.a_b_c-0123456789ab.log.gz",
    "kube.var.log.containers.a_b_c-0123456789ABCDEF.log",
    "x.a_b_c-0123456789ab.log",
    "kube.var.log.containers.9_ns-1_c-d-e-abcdefabcdef.log",
    "kube.var.log.containers.a__c-0123456789ab.log",
]


def test_tag_identity_equals_reference_and_python_re():
    from fluentbit_tpu.core.plugin import registry as jreg
    from fluentbit_tpu_torch.core.plugin import registry as treg
    from fluentbit_tpu_torch.plugins.filter_kubernetes import TAG_REGEX

    plugins = []
    for reg in (jreg, treg):
        ins = reg.create_filter("kubernetes")
        ins.configure()
        ins.plugin.init(ins, None)
        plugins.append(ins.plugin)
    py = re.compile(TAG_REGEX.replace("(?<", "(?P<"))
    prefix = "kube.var.log.containers."
    for tag in ODD_TAGS:
        want = plugins[0].tag_to_identity(tag)
        assert plugins[1].tag_to_identity(tag) == want, tag
        rest = tag[len(prefix):] if tag.startswith(prefix) else tag
        m = py.search(rest)
        assert want == (m.groupdict() if m else None), tag
    assert plugins[1].tag_to_identity(ODD_TAGS[0])["pod_name"] == "web.v2-7f9c"
    assert plugins[1].tag_to_identity(ODD_TAGS[1])["container_name"] \
        == "side_car"


# ------------------------------------------------------------- kube_url


@pytest.fixture(scope="module")
def certs(tmp_path_factory):
    d = tmp_path_factory.mktemp("kubecerts")
    crt, key = str(d / "srv.crt"), str(d / "srv.key")
    subprocess.run(
        ["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
         "-keyout", key, "-out", crt, "-days", "2",
         "-subj", "/CN=127.0.0.1",
         "-addext", "subjectAltName=DNS:localhost,IP:127.0.0.1"],
        check=True, capture_output=True)
    return crt, key


class ApiServer:
    """A minimal apiserver on loopback: wants ``Bearer <token>`` with a
    token of ``expected``, answers the pod object (``chunked`` in
    transfer, when asked), else 401. TLS when ``certs`` is given."""

    def __init__(self, certs, expected, chunked=False):
        self.requests = []
        self.expected = expected
        self.chunked = chunked
        self.ctx = None
        if certs:
            self.ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            self.ctx.load_cert_chain(*certs)
        self.srv = socket.socket()
        self.srv.bind(("127.0.0.1", 0))
        self.srv.listen(4)
        self.port = self.srv.getsockname()[1]
        threading.Thread(target=self._serve, daemon=True).start()

    def _serve(self):
        while True:
            try:
                conn, _ = self.srv.accept()
            except OSError:
                return
            try:
                if self.ctx is not None:
                    conn = self.ctx.wrap_socket(conn, server_side=True)
                conn.settimeout(3)
                data = b""
                while b"\r\n\r\n" not in data:
                    data += conn.recv(65536)
                head = data.partition(b"\r\n\r\n")[0].decode()
                self.requests.append(head)
                auth = ""
                for line in head.split("\r\n"):
                    if line.lower().startswith("authorization:"):
                        auth = line.split(":", 1)[1].strip()
                if auth.replace("Bearer ", "") in self.expected:
                    pod = {"metadata": {
                        "name": "mypod", "namespace": "ns1", "uid": "u-1",
                        "labels": {"app": "web"},
                        "annotations": {"note": "hi"}},
                        "spec": {"nodeName": "n1"}}
                    body = json.dumps(pod).encode()
                    if self.chunked:
                        half = len(body) // 2
                        conn.sendall(
                            b"HTTP/1.1 200 OK\r\nTransfer-Encoding: "
                            b"chunked\r\n\r\n"
                            + b"%x\r\n" % half + body[:half] + b"\r\n"
                            + b"%x\r\n" % (len(body) - half) + body[half:]
                            + b"\r\n0\r\n\r\n")
                    else:
                        conn.sendall(b"HTTP/1.1 200 OK\r\nContent-Length: "
                                     + str(len(body)).encode()
                                     + b"\r\n\r\n" + body)
                else:
                    conn.sendall(b"HTTP/1.1 401 Unauthorized\r\n"
                                 b"Content-Length: 0\r\n\r\n")
            except (OSError, ssl.SSLError):
                pass
            conn.close()

    def close(self):
        self.srv.close()


def make_kube(url, ca_file, token_file=None, token_command=None,
              token_ttl="10m", package="port"):
    from fluentbit_tpu.core.plugin import registry as jreg
    from fluentbit_tpu_torch.core.plugin import registry as treg

    ins = (treg if package == "port" else jreg).create_filter("kubernetes")
    ins.set("kube_url", url)
    ins.set("kube_ca_file", ca_file)
    ins.set("kube_token_file", token_file or "/nonexistent")
    if token_command:
        ins.set("kube_token_command", token_command)
    ins.set("kube_token_ttl", token_ttl)
    ins.configure()
    ins.plugin.init(ins, None)
    return ins.plugin


@pytest.mark.parametrize("package", ["port", "reference"])
def test_https_fetch_with_token_file(certs, tmp_path, package):
    tok = tmp_path / "token"
    tok.write_text("sa-token-1\n")
    srv = ApiServer(certs, {"sa-token-1"})
    try:
        k = make_kube(f"https://127.0.0.1:{srv.port}", certs[0],
                      token_file=str(tok), package=package)
        meta = k._fetch_meta("ns1", "mypod")
    finally:
        srv.close()
    assert meta["metadata"]["labels"] == {"app": "web"}
    assert any("Authorization: Bearer sa-token-1" in r
               for r in srv.requests)
    assert srv.requests[0].startswith(
        "GET /api/v1/namespaces/ns1/pods/mypod HTTP/1.1")


def test_https_verifies_ca(certs, tmp_path):
    """With a wrong CA the handshake fails closed (no meta), as in the
    reference."""
    wrong_ca, wrong_key = tmp_path / "other.crt", tmp_path / "other.key"
    subprocess.run(
        ["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
         "-keyout", str(wrong_key), "-out", str(wrong_ca), "-days", "2",
         "-subj", "/CN=untrusted"], check=True, capture_output=True)
    tok = tmp_path / "token"
    tok.write_text("sa-token-1")
    srv = ApiServer(certs, {"sa-token-1"})
    try:
        got = [make_kube(f"https://127.0.0.1:{srv.port}", str(wrong_ca),
                         token_file=str(tok), package=p
                         )._fetch_meta("ns1", "mypod")
               for p in ("port", "reference")]
    finally:
        srv.close()
    assert got == [{}, {}]


def test_token_command_and_ttl_refresh(certs, tmp_path):
    counter = tmp_path / "n"
    counter.write_text("0")
    script = tmp_path / "tok.sh"
    script.write_text(
        f"#!/bin/sh\nn=$(cat {counter})\nn=$((n+1))\n"
        f"echo $n > {counter}\necho cmd-token-$n\n")
    script.chmod(0o755)
    srv = ApiServer(certs, {"cmd-token-1", "cmd-token-2"})
    try:
        k = make_kube(f"https://127.0.0.1:{srv.port}", certs[0],
                      token_command=str(script), token_ttl="1000s")
        assert k._fetch_meta("ns1", "mypod")
        assert k._fetch_meta("ns1", "mypod")
        assert counter.read_text().strip() == "1"  # cached, no re-run
        k._token_created -= 2000  # age past the TTL
        assert k._fetch_meta("ns1", "mypod")
        assert counter.read_text().strip() == "2"  # refreshed
    finally:
        srv.close()
    assert any("Bearer cmd-token-2" in r for r in srv.requests)


def test_failed_token_refresh_backs_off(tmp_path):
    """A failing token command runs once, then not again for 30 s."""
    counter = tmp_path / "n"
    counter.write_text("0")
    script = tmp_path / "tok.sh"
    script.write_text(f"#!/bin/sh\nn=$(cat {counter})\n"
                      f"echo $((n+1)) > {counter}\nexit 1\n")
    script.chmod(0o755)
    srv = ApiServer(None, {"never"})
    try:
        k = make_kube(f"http://127.0.0.1:{srv.port}", "",
                      token_command=str(script))
        assert k._fetch_meta("ns1", "a") == {}
        assert k._fetch_meta("ns1", "b") == {}
        assert counter.read_text().strip() == "1"
        k._token_retry_at -= 31
        k._fetch_meta("ns1", "c")
        assert counter.read_text().strip() == "2"
    finally:
        srv.close()


def test_rotated_token_retries_once_on_401(certs, tmp_path):
    tok = tmp_path / "token"
    tok.write_text("old-token")
    srv = ApiServer(certs, {"new-token"})
    try:
        k = make_kube(f"https://127.0.0.1:{srv.port}", certs[0],
                      token_file=str(tok))
        assert k._fetch_meta("ns1", "mypod") == {}  # old token rejected
        n = len(srv.requests)
        assert n == 2  # the 401 re-read the same old token and retried
        tok.write_text("new-token")  # the kubelet rotated the token
        meta = k._fetch_meta("ns1", "mypod")
    finally:
        srv.close()
    assert meta.get("metadata", {}).get("name") == "mypod"
    assert any("Bearer new-token" in r for r in srv.requests)


def test_http_kube_url_chunked_feeds_the_filter(tmp_path):
    """kube_url over plain http with a chunked body: the pipeline of
    both packages enriches from it alike (and caches it)."""
    srv = ApiServer(None, {"t"}, chunked=True)
    tok = tmp_path / "token"
    tok.write_text("t")
    tag = "kube.var.log.containers.mypod_ns1_app-0123456789ab.log"
    try:
        evs = both_lib([{"log": "a"}, {"log": "b"}], tag, [(
            "kubernetes", dict(match="kube.*",
                               kube_url=f"http://127.0.0.1:{srv.port}",
                               kube_token_file=str(tok)))])
    finally:
        srv.close()
    assert evs[1]["kubernetes"]["pod_id"] == "u-1"
    assert evs[1]["kubernetes"]["host"] == "n1"
    assert len(srv.requests) == 2  # one fetch a package


def test_sync_http_request_equals_reference():
    from fluentbit_tpu.utils import sync_http_request as jget
    from fluentbit_tpu_torch.utils import sync_http_request

    srv = ApiServer(None, {"t"}, chunked=True)
    try:
        for fn in (sync_http_request, jget):
            got = fn("127.0.0.1", srv.port, "GET", "/x",
                     headers={"Authorization": "Bearer t"}, timeout=3)
            assert got == jget("127.0.0.1", srv.port, "GET", "/x",
                               headers={"Authorization": "Bearer t"},
                               timeout=3)
        assert sync_http_request("127.0.0.1", 1, "GET", "/", timeout=1) \
            is None
    finally:
        srv.close()
    assert got[0] == 200 and json.loads(got[2])["metadata"]["uid"] == "u-1"


def test_unknown_merge_parser_raises():
    ctx = flb.create(device="cpu")
    ctx.filter("kubernetes", merge_parser="nope")
    with pytest.raises(ValueError, match="unknown merge_parser 'nope'"):
        ctx.start()


# ------------------------------------------------------- config 5 end to end


def k8s_traffic(seed, tmp_path, n_pods=12, n_records=3000):
    """Seeded k8s traffic at a small size: pods in 4 namespaces with 1-3
    containers each, a preload cache for 90% of the pods, and forward
    messages (packed, gzip, forward, message; 1-600 entries) of Docker
    style ``log`` lines: JSON, plain text, probes with ``health-check``,
    lines over 512 B and invalid UTF-8, with ``stream`` and ``time``."""
    rng = np.random.default_rng(seed)
    cache = tmp_path / "meta"
    cache.mkdir()
    tags = []
    for p in range(n_pods):
        ns, pod = f"ns{p % 4}", f"app{p}-{p * 7919 % 100000:05x}"
        if p < n_pods * 9 // 10:
            (cache / f"{ns}_{pod}.meta").write_text(json.dumps({
                "metadata": {"uid": f"uid-{p}", "labels": {
                    f"l{i}": f"v{p}-{i}" for i in range(2 + p % 7)},
                    "annotations": {f"a{i}": "x" for i in range(p % 5)}},
                "spec": {"nodeName": f"node-{p % 32}"}}))
        for c in range(1 + p % 3):
            hexid = "".join("0123456789abcdef"[int(x)]
                            for x in rng.integers(0, 16, 64))
            tags.append(f"kube.var.log.containers.{pod}_{ns}_c{c}-{hexid}"
                        ".log")
    msgs, n = [], 0
    while n < n_records:
        size = int(rng.choice([1, 5, 31, 32, 200, 600]))
        tag = tags[int(rng.integers(len(tags)))]
        ents = []
        for _ in range(size):
            r = rng.random()
            if r < 0.55:
                line = json.dumps({"level": "info", "n": n, "msg":
                                   "x" * int(rng.integers(40, 300)),
                                   "stream": "inner"})
            elif r < 0.95:
                line = f"plain text line {n} " + "y" * int(
                    rng.integers(10, 200))
            elif r < 0.98:
                line = f"GET /healthz health-check {n} probe"
            else:
                line = "Traceback:\n" + "  at frame\n" * 60
            if rng.random() < 0.01:
                line = "\u0001INVALID\u0001" + line
            ents.append([EventTime(1700000000 + n, n), {
                "log": line + "\n", "stream": "stdout",
                "time": f"2024-01-01T00:00:{n % 60:02d}.0Z"}])
            n += 1
        mode = ["packed", "gzip", "forward", "message"][
            0 if size > 1 and rng.random() < 0.5 else
            1 if size > 1 and rng.random() < 0.8 else
            2 if size > 1 else 3]
        msgs.append((tag, message(tag, mode, ents, {"chunk": f"k{len(msgs)}"}),
                     f"k{len(msgs)}", size))
    return str(cache), msgs, n


def send_on_four(port, msgs):
    """Each tag's messages in order on one of four connections (by the
    tag's first appearance), the connections at once; every message's
    ack is awaited."""
    conn_of, parts = {}, [[], [], [], []]
    for m in msgs:
        parts[conn_of.setdefault(m[0], len(conn_of) % 4)].append(m)

    def run(part):
        c = Client(port)
        for _tag, data, ack, _size in part:
            c.send(data, ack)
        c.close()

    threads = [threading.Thread(target=run, args=(p,)) for p in parts]
    for t in threads:
        t.start()
    for t in threads:
        t.join()


def config5_run(create, cache, msgs, **kw):
    filters = [("kubernetes", dict(match="kube.*", merge_log="on",
                                   buffer_size="0",
                                   kube_meta_preload_cache_dir=cache)),
               ("grep", dict(match="kube.*", exclude="log health-check"))]
    got, ctx = serve(create, lambda port: send_on_four(port, msgs), 0,
                     filters=filters, **kw)
    return got, ctx.engine.filters[1].plugin


def test_config5_end_to_end_equals_reference(tmp_path):
    """Config 5's chain on seeded traffic (each tag sent on one of four
    connections, so each tag's order is fixed): the port's lib output,
    tag by tag, equals the reference's; health-check lines are gone,
    JSON lines merged, every record enriched."""
    cache, msgs, n = k8s_traffic(21, tmp_path)
    want, _ = config5_run(ref.create, cache, msgs)
    got, grep = config5_run(flb.create, cache, msgs, device="cpu")
    big = sum(1 for m in msgs if m[3] >= 32)
    assert big and len(grep.match_seconds) == big  # the device path
    assert got.keys() == want.keys()
    for tag in want:
        # the reference's in the order sent (push_ordered: its last
        # flush_now may queue a tag's chunks in either order)
        assert got[tag] == push_ordered_bytes(want[tag]), tag
    bodies = [ev.body for v in got.values() for ev in tdecode(v)]
    assert 0.9 * n < len(bodies) < n
    assert not any("health-check" in b["log"] for b in bodies)
    assert all("kubernetes" in b for b in bodies)
    merged = [b for b in bodies if b.get("stream") == "stdout"
              and "level" in b]
    assert merged and all(b["level"] == "info" for b in merged)
