"""K5, the sharded grep dispatch, in the port against the reference.

The port's ``match_mesh`` / ``dispatch_mesh`` / ``match_sharded`` over a
hand-built ``Mesh((cpu,) * n)`` (each shard runs the kernels' plain
versions) against the reference's ``shard_map`` programs over the first
n of its 8 virtual CPU devices (tests/conftest.py), for n in {1, 2, 8}:
masks, per-rule counts and the padded batch size ``Bp`` must be equal,
for the batch variant, the rules variant (``FBTPU_MESH_RULE_SHARD_R``),
a k-split program (apache2 + an Exclude rule: two children), the
variant gate (R not divisible by the shard count), ``with_counts=False``,
and the grep filter's mesh staging branch against its unsharded one.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from fluentbit_tpu.ops.grep import GrepProgram
from fluentbit_tpu_torch.codec.events import encode_event
from fluentbit_tpu_torch.codec.msgpack import EventTime
from fluentbit_tpu_torch.ops import mesh as tmesh
from fluentbit_tpu_torch.ops.batch import assemble, bucket_size
from fluentbit_tpu_torch.ops.grep import TorchGrepProgram
from fluentbit_tpu_torch.regex.dfa import compile_dfa
from fluentbit_tpu.regex.dfa import compile_dfa as jax_compile_dfa

APACHE2 = (
    r'^(?<host>[^ ]*) [^ ]* (?<user>[^ ]*) \[(?<time>[^\]]*)\] '
    r'"(?<method>\S+)(?: +(?<path>[^ ]*) +\S*)?" '
    r'(?<code>[^ ]*) (?<size>[^ ]*)'
    r'(?: "(?<referer>[^\"]*)" "(?<agent>.*)")?$'
)
EXCLUDE = r'HTTP/1\.1" 500 '
CONFIG3 = ["sshd", "kernel:", r"systemd\[1\]", "ERROR", "WARN", "nginx",
           r"cron\[\d+\]", ".*OOM.*"]
CORPUS = [
    b'10.0.0.1 - frank [10/Oct/2000:13:55:36 -0700] '
    b'"GET /a HTTP/1.1" 200 23 "http://r" "curl"',
    b'10.0.0.2 - - [10/Oct/2000:13:55:36 -0700] "GET /b HTTP/1.1" 500 7',
    b"kernel: panic at cpu0 sshd[1]: OOM",
    b"",
    None,  # missing field row
    b"Jan 1 cron[42]: WARN nginx ERROR systemd[1]",
    b"x" * 200,  # past the row width: -2
]
L = 128


def _stage(vals, R):
    b = assemble(vals, L)
    return np.stack([b.batch] * R), np.stack([b.lengths] * R)


def _meshes(n):
    cpu = torch.device("cpu")
    return (tmesh.Mesh((cpu,) * n),
            JaxMesh(np.asarray(jax.devices()[:n]), ("batch",)))


def _programs(patterns):
    return (TorchGrepProgram([compile_dfa(p) for p in patterns], L, "cpu"),
            GrepProgram([jax_compile_dfa(p) for p in patterns], L))


def _check(patterns, n, B, variant=None):
    port, ref = _programs(patterns)
    mesh, jmesh = _meshes(n)
    assert port.mesh_variant(mesh) == ref.mesh_variant(jmesh)
    if variant is not None:
        assert port.mesh_variant(mesh) == variant
    vals = (CORPUS * (B // len(CORPUS) + 1))[:B]
    batch, lengths = _stage(vals, len(patterns))
    mask, counts, Bp = port.match_mesh(mesh, batch, lengths)
    rmask, rcounts, rBp = ref.match_mesh(jmesh, batch, lengths)
    assert np.array_equal(mask, rmask)
    assert np.array_equal(counts, rcounts)
    assert Bp == rBp
    assert np.array_equal(counts, mask.sum(axis=1))
    assert np.array_equal(mask, port.match(batch, lengths))
    return port, mesh, batch, lengths, mask


@pytest.mark.parametrize("n", [1, 2, 8])
@pytest.mark.parametrize("B", [59, 8, 1, 0])
def test_batch_variant_equals_reference(n, B):
    port, mesh, batch, lengths, mask = _check([APACHE2], n, B, "batch")
    # with_counts=False: the same verdicts, no count computed
    m, counts, b, bp = port.dispatch_mesh(mesh, batch, lengths,
                                          with_counts=False)
    assert counts is None and (b, bp) == (B, tmesh.pad_to_devices(B, n))
    assert np.array_equal(m[:, :B].numpy(), mask)
    assert not m[:, B:].any()  # pad rows never match


@pytest.mark.parametrize("n", [1, 2, 8])
def test_k_split_children_equal_reference(n):
    port, mesh, batch, lengths, mask = _check([APACHE2, EXCLUDE], n, 43,
                                              "batch")
    assert port._children is not None and len(port._children) == 2
    rport, rref = _programs([APACHE2, EXCLUDE])
    jmesh = _meshes(n)[1]
    got = port.match_sharded(mesh, batch, lengths)
    want = rref.match_sharded(jmesh, batch, lengths)
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1])
    assert got[2] == want[2]


@pytest.mark.parametrize("n", [1, 2, 8])
def test_rules_variant_equals_reference(n, monkeypatch):
    monkeypatch.setenv("FBTPU_MESH_RULE_SHARD_R", "2")
    port, mesh, batch, lengths, mask = _check(CONFIG3, n, 37, "rules")
    # one fused table set: the rule-shard count suppresses the k split
    assert port._children is None
    assert mask.any(axis=1).all()
    shards = port._mesh_tables(mesh, "rules")
    assert [t["trans_flat"].shape[0] for t in shards] == [8 // n] * n


@pytest.mark.parametrize("n", [2, 8])
def test_variant_gate_needs_divisible_rules(n, monkeypatch):
    monkeypatch.setenv("FBTPU_MESH_RULE_SHARD_R", "2")
    _check(["GET", "POST", "panic"], n, 21, "batch")
    monkeypatch.setenv("FBTPU_MESH_TABLE_BUDGET", "1")
    monkeypatch.setenv("FBTPU_MESH_RULE_SHARD_R", "64")
    _check(["GET", "POST"], 2, 21, "rules")


def test_mesh_helpers():
    cpu = torch.device("cpu")
    mesh = tmesh.Mesh((cpu,) * 8)
    assert tmesh.mesh_info(mesh) == {"devices": 8, "axis_names": ["batch"],
                                     "platform": "cpu", "simulated": True}
    assert tmesh.mesh_key(mesh) == tmesh.mesh_key(tmesh.Mesh(["cpu"] * 8))
    assert tmesh.pad_to_devices(42, 8) == 48
    assert tmesh.pad_to_devices(16, 8) == 16
    assert bucket_size(100, multiple_of=3) == 258
    if not torch.cuda.is_available():
        assert tmesh.build_mesh() is None
    rules = tmesh.partition_rules("grep-rules", "batch")
    t = torch.arange(8 * 3).reshape(8, 3)
    assert tmesh.shard_leaf(rules, "trans_flat", t, "batch", 4, 1).tolist() \
        == t[2:4].tolist()
    b = tmesh.partition_rules("grep-batch", "batch")
    assert tmesh.shard_leaf(b, "trans_flat", t, "batch", 4, 1) is t
    with pytest.raises(KeyError):
        tmesh.partition_rules("grep-nope", "batch")
    with pytest.raises(ValueError):
        tmesh.shard_leaf(rules, "starts", torch.arange(3), "batch", 2, 0)
    table = {"trans_flat": np.zeros((2, 5), np.int32), "pair_maps": None}
    assert tmesh.replicated_table_bytes(table) == 40


def _chunk(n, seed):
    rng = np.random.default_rng(seed)
    vals = [CORPUS[i] for i in rng.integers(0, len(CORPUS), n)]
    return b"".join(encode_event({} if v is None else {"log": v.decode()},
                                 EventTime(i, 0))
                    for i, v in enumerate(vals))


@pytest.mark.parametrize("n", [1, 2, 8])
def test_filter_mesh_staging_equals_unsharded(n, monkeypatch):
    import fluentbit_tpu_torch

    monkeypatch.setenv("FBTPU_SEGMENT_RECORDS", "256")
    ctx = fluentbit_tpu_torch.create(device="cpu")
    f = ctx.filter("grep", match="*", tpu_max_record_len=str(L))
    ctx.set(f, exclude="log " + EXCLUDE)
    ctx.set(f, regex="log " + APACHE2)
    grep = ctx.engine.filters[0]
    grep.configure()
    grep.plugin.init(grep, ctx.engine)
    mesh = tmesh.Mesh((torch.device("cpu"),) * n)
    calls = []
    real = TorchGrepProgram.dispatch_mesh

    def counting(self, *a, **kw):
        if self is grep.plugin._program:  # not the children's calls
            calls.append(kw.get("with_counts"))
        return real(self, *a, **kw)

    monkeypatch.setattr(TorchGrepProgram, "dispatch_mesh", counting)
    for records in (300, 700):
        data = _chunk(records, records + n)
        m1, o1, n1 = grep.plugin._device_match_raw(data, records, mesh=mesh)
        m0, o0, n0 = grep.plugin._device_match_raw(data, records)
        assert n1 == n0 == records
        assert np.array_equal(m1, m0) and np.array_equal(o1, o0)
        assert m0.any() and not m0.all()
    assert calls == [False] * (2 + 3)  # one per segment, no counts
