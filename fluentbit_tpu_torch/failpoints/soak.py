"""Crash-recovery soak harness: the failpoint plane's proving ground.

The port's own copy of the core of ``fluentbit_tpu/failpoints/soak.py``.
A *scenario* runs the pipeline in a child process with filesystem
storage and a failpoint armed to ``crash`` (SIGKILL semantics: no drain,
no atexit) at a chosen data-plane site mid-ingest, then restarts over
the same storage root and lets recovery deliver the backlog. The parent
holds the run to the durability contract:

1. every record whose ingest **ack** was observed (the child acks a
   sequence number only after ``push`` returned, after the write-through
   landed) is delivered at least once across all runs, except the
   records the scenario declares lossy (a torn or unflushed last write:
   a crash loses at most the last partial write);
2. un-finalized chunks recover to the last whole record, finalized
   chunks recover completely;
3. corruption injected into an on-disk chunk is quarantined into the DLQ
   (never delivered, never silently dropped);
4. delivery is at least once, with duplicates bounded by the redelivery
   window: a sequence delivered more than once was on disk at the crash
   (delivered by an earlier run whose chunk file outlived it), and none
   is delivered more than ``1 + restarts + declared_retries`` times.

Child protocol (``python -m fluentbit_tpu_torch.failpoints.soak``): the
failpoints arrive in ``FBTPU_FAILPOINTS`` (armed at import, before the
engine exists); ``ingested.log`` records acks and ``delivered.log``
deliveries, each line fsynced so it survives the SIGKILL. The delivery
sink honours a ``soak.deliver`` failpoint, so retry scenarios come from
the same DSL. ``--device`` is the engine's device: the tests pass
``cpu``, a card's smoke ``cuda``. ``--grep`` puts config 1's grep rule
(apache2, which the ``log`` of each record carries) on the path, so the
raw path's kernel runs under the crash.

Not here yet: the relay mode (edge and aggregator children over the
forward hop), hot reloads under load (``--reloads``) and quota floods
(``--flood-rate``), each with the module it needs.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from typing import Dict, List, Optional, Sequence

from . import FailpointError, fire

DELIVERED_LOG = "delivered.log"
INGESTED_LOG = "ingested.log"
STORAGE_DIR = "storage"

#: config 1's parser (parsers.conf apache2), the rule ``--grep`` adds
APACHE2 = (
    r'^(?<host>[^ ]*) [^ ]* (?<user>[^ ]*) \[(?<time>[^\]]*)\] '
    r'"(?<method>\S+)(?: +(?<path>[^ ]*) +\S*)?" '
    r'(?<code>[^ ]*) (?<size>[^ ]*)'
    r'(?: "(?<referer>[^\"]*)" "(?<agent>.*)")?$'
)


def _append_line(path: str, text: str) -> None:
    """Append one line and force it to disk: the logs are the ground
    truth the parent audits after a SIGKILL."""
    with open(path, "a", encoding="utf-8") as f:
        f.write(text + "\n")
        f.flush()
        os.fsync(f.fileno())


def soak_record(seq: int) -> dict:
    """Record ``seq`` of a run: its sequence number and an access-log
    line that config 1's apache2 rule keeps."""
    return {"seq": seq,
            "log": f'10.0.{seq % 256}.{seq % 7} - user{seq % 13} '
                   f'[10/Oct/2023:13:55:{seq % 60:02d} +0000] '
                   f'"GET /item/{seq} HTTP/1.1" 200 {100 + seq}'}


def _register_sink():
    """Register the soak's delivery sink (once a process)."""
    from ..codec.events import decode_events
    from ..core.config import ConfigMapEntry
    from ..core.plugin import FlushResult, OutputPlugin, registry

    if "soak_sink" in registry.outputs:
        return

    @registry.register
    class SoakSink(OutputPlugin):
        """The delivery ledger: one fsynced line a flush."""

        name = "soak_sink"
        description = "crash-recovery soak delivery ledger"
        config_map = [
            ConfigMapEntry("path", "str"),
            ConfigMapEntry("run_id", "str", default="0"),
        ]

        async def flush(self, data: bytes, tag: str, engine) -> FlushResult:
            from .. import failpoints as _fp

            if _fp.ACTIVE:
                try:
                    fire("soak.deliver")
                except FailpointError:
                    return FlushResult.RETRY
            seqs = [ev.body.get("seq") for ev in decode_events(data)]
            _append_line(self.path, json.dumps(
                {"run": self.run_id, "tag": tag, "seqs": seqs}))
            return FlushResult.OK


def child_main(argv: Optional[Sequence[str]] = None) -> int:
    """One child run: ``ingest`` pushes the records and acks each one
    accepted; ``recover`` starts over the same root and waits until the
    backlog is delivered (at most ``--settle`` seconds)."""
    import argparse

    ap = argparse.ArgumentParser(prog="fbtpu-torch-soak-child")
    ap.add_argument("--workdir", required=True)
    ap.add_argument("--mode", choices=("ingest", "recover"),
                    default="ingest")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--records", type=int, default=20)
    ap.add_argument("--batch", type=int, default=1,
                    help="records a push (one append)")
    ap.add_argument("--tags", type=int, default=1,
                    help="pushes round-robin over N tags (N chunks)")
    ap.add_argument("--grep", action="store_true",
                    help="config 1's grep rule on the path")
    ap.add_argument("--flush", default="200ms")
    ap.add_argument("--run-id", default="0")
    ap.add_argument("--final-flush", action="store_true",
                    help="flush_now after the last push (drives the "
                    "drain-time failpoints deterministically)")
    ap.add_argument("--settle", type=float, default=2.0,
                    help="recover mode: seconds to wait for redelivery")
    args = ap.parse_args(argv)

    import fluentbit_tpu_torch as flb

    _register_sink()
    os.makedirs(args.workdir, exist_ok=True)
    delivered = os.path.join(args.workdir, DELIVERED_LOG)
    ingested = os.path.join(args.workdir, INGESTED_LOG)
    ctx = flb.create(device=args.device, flush=args.flush, grace="2", **{
        "storage.path": os.path.join(args.workdir, STORAGE_DIR),
        "storage.checksum": "on",
        "scheduler.base": "0.05", "scheduler.cap": "0.1",
    })
    in_ffd = [ctx.input("lib", tag=f"soak.{i}",
                        **{"storage.type": "filesystem"})
              for i in range(max(1, args.tags))]
    if args.grep:
        ctx.filter("grep", match="soak.*", regex="log " + APACHE2)
    ctx.output("soak_sink", match="soak.*", path=delivered,
               run_id=args.run_id)
    ctx.start()
    try:
        if args.mode == "ingest":
            for p, first in enumerate(range(0, args.records, args.batch)):
                seqs = range(first, min(first + args.batch, args.records))
                got = ctx.push(in_ffd[p % len(in_ffd)],
                               json.dumps([soak_record(s) for s in seqs]))
                if got:
                    # acked after push returned: the write-through is on
                    # disk
                    _append_line(ingested,
                                 "\n".join(str(s) for s in seqs))
            if args.final_flush:
                ctx.flush_now()
        else:
            deadline = time.time() + args.settle
            e = ctx.engine
            while time.time() < deadline:
                if not e._backlog and not e._task_map \
                        and not e._pending_flushes \
                        and not e._pending_retries:
                    break
                time.sleep(0.05)
            st = e.storage
            # the recovery's own figures, for the parent to read
            _append_line(os.path.join(args.workdir, "recover.json"),
                         json.dumps({
                             "run": args.run_id,
                             "sidecar_hits": st.replay_sidecar_hits,
                             "sidecar_trusted": st.replay_sidecar_trusted,
                             "decode_walks": st.replay_decode_walks,
                             "replay_seconds": st.replay_seconds}))
    finally:
        ctx.stop()
    return 0


# ---------------------------------------------------------------- parent


class SoakOutcome:
    """What one scenario produced, read back from its logs."""

    def __init__(self, workdir: str):
        self.workdir = workdir
        self.acked: List[int] = []
        self.deliveries: Dict[str, List[int]] = {}  # run id → seqs
        ing = os.path.join(workdir, INGESTED_LOG)
        if os.path.exists(ing):
            with open(ing, encoding="utf-8") as f:
                self.acked = [int(s) for s in f.read().split()]
        dlv = os.path.join(workdir, DELIVERED_LOG)
        if os.path.exists(dlv):
            with open(dlv, encoding="utf-8") as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        obj = json.loads(line)
                    except ValueError:
                        continue  # a torn last line from a mid-write kill
                    self.deliveries.setdefault(str(obj["run"]), []).extend(
                        s for s in obj["seqs"] if s is not None)

    def delivered_all(self) -> List[int]:
        return [s for seqs in self.deliveries.values() for s in seqs]

    def dlq_files(self) -> List[str]:
        d = os.path.join(self.workdir, STORAGE_DIR, "dlq")
        return sorted(os.listdir(d)) if os.path.isdir(d) else []

    def stream_files(self) -> List[str]:
        out = []
        root = os.path.join(self.workdir, STORAGE_DIR, "streams")
        for dirpath, _dirs, files in os.walk(root):
            out.extend(os.path.join(dirpath, n) for n in files)
        return sorted(out)


def child_command(workdir: str, mode: str, *, device: str,
                  failpoints: str = "", seed: int = 0, records: int = 20,
                  batch: int = 1, tags: int = 1, grep: bool = False,
                  flush: str = "200ms", run_id: str = "0",
                  final_flush: bool = False, settle: float = 2.0):
    """(argv, env, cwd) of one soak child."""
    env = dict(os.environ)
    env["FBTPU_FAILPOINTS"] = failpoints
    env["FBTPU_FAILPOINTS_SEED"] = str(seed)
    cmd = [sys.executable, "-m", "fluentbit_tpu_torch.failpoints.soak",
           "--workdir", workdir, "--mode", mode, "--device", device,
           "--records", str(records), "--batch", str(batch),
           "--tags", str(tags), "--flush", flush, "--run-id", run_id,
           "--settle", str(settle)]
    if grep:
        cmd.append("--grep")
    if final_flush:
        cmd.append("--final-flush")
    cwd = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return cmd, env, cwd


def spawn_child(workdir: str, mode: str, **kw) -> "subprocess.Popen":
    """Start one child without waiting (scenarios run side by side); its
    output goes to ``<workdir>/child.log``."""
    cmd, env, cwd = child_command(workdir, mode, **kw)
    os.makedirs(workdir, exist_ok=True)
    with open(os.path.join(workdir, "child.log"), "ab") as logf:
        return subprocess.Popen(cmd, env=env, cwd=cwd, stdout=logf,
                                stderr=subprocess.STDOUT)


def wait_child(proc: "subprocess.Popen", workdir: str,
               timeout: float = 120.0) -> int:
    """Wait for a child; returns its exit code (a crash failpoint shows
    as ``-SIGKILL``). Any other failure raises with the child's log."""
    try:
        rc = proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        raise
    if rc not in (0, -9, 137):
        with open(os.path.join(workdir, "child.log"), "rb") as f:
            tail = f.read()[-4000:].decode("utf-8", "replace")
        raise RuntimeError(f"soak child exited {rc}:\n{tail}")
    return rc


def run_child(workdir: str, mode: str, timeout: float = 120.0, **kw) -> int:
    """Run one child to its end; returns its exit code."""
    return wait_child(spawn_child(workdir, mode, **kw), workdir, timeout)


def verify_contract(outcome: SoakOutcome, *, restarts: int,
                    allowed_missing: Sequence[int] = (),
                    quarantined: Sequence[int] = (),
                    declared_retries: int = 0) -> None:
    """Hold a finished scenario to the durability contract; raises
    ``AssertionError`` naming the clause broken.

    ``allowed_missing``: sequences the scenario declares lossy (the torn
    or unflushed last write). ``quarantined``: sequences whose chunk was
    corrupted on disk: none of them may be delivered, and the DLQ must
    hold a file."""
    def check(ok: bool, what: str) -> None:
        if not ok:
            raise AssertionError(what)

    delivered = outcome.delivered_all()
    got = set(delivered)
    missing = set(outcome.acked) - got
    illegal = missing - set(allowed_missing) - set(quarantined)
    check(not illegal, f"acked records lost across crash and recovery: "
          f"{sorted(illegal)} (acked={len(set(outcome.acked))}, "
          f"delivered={len(got)}, dlq={outcome.dlq_files()})")
    for s in quarantined:
        check(s not in got, f"corrupted seq {s} was delivered")
    if quarantined:
        check(bool(outcome.dlq_files()), "corruption must land in the DLQ")
    bound = 1 + restarts + declared_retries
    counts: Dict[int, int] = {}
    for s in delivered:
        counts[s] = counts.get(s, 0) + 1
    over = {s: c for s, c in counts.items() if c > bound}
    check(not over, f"deliveries beyond the redelivery window: {over}")
    dup = {s for s, c in counts.items() if c > 1}
    if dup and not declared_retries:
        # a duplicate is a redelivery: delivered by two runs
        per_run = [set(v) for v in outcome.deliveries.values()]
        for s in dup:
            check(sum(1 for seqs in per_run if s in seqs) >= 2,
                  f"seq {s} duplicated within one run with no declared "
                  "retries")


if __name__ == "__main__":  # exercised through subprocess
    sys.exit(child_main())
