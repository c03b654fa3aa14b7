"""CLI: ``python -m fluentbit_tpu_torch``.

The port's own copy of ``fluentbit_tpu/__main__.py`` (reference
src/fluent-bit.c: long options :1038, signal handlers :704-716). Options
apply in order: ``-p`` sets a property on the most recent ``-i`` / ``-F``
/ ``-o`` instance. SIGINT and SIGTERM stop gracefully (exit 0); SIGHUP,
with the service's ``hot_reload`` on and a ``-c`` file, validates the
whole command line again into a new pipeline and only then stops the old
one and starts the new (a full restart; a broken edit keeps the running
pipeline); with ``hot_reload`` off it is ignored with a warning.
``--supervisor`` runs the worker under ``supervisor.run_supervised``
before anything resolves a device, so the parent never touches CUDA.

One option is the port's own: ``--device {cuda,cpu}`` (default
``cuda``), the CLI's form of ``create(device=)``. Without CUDA and
without ``--device cpu`` the CLI raises, as ``create()`` does; it never
carries on on the CPU by itself. Options that need what is not ported
raise by name: ``-e`` (dynamic plugins), ``-H`` / ``-P`` (the admin HTTP
server), and a reload onto a fleet-managed config path.

Usage examples::

    python -m fluentbit_tpu_torch -i dummy -o stdout -f 1
    python -m fluentbit_tpu_torch --device cpu -c pipeline.conf
    python -m fluentbit_tpu_torch --supervisor -c aggregator.conf
"""

from __future__ import annotations

import logging
import os
import signal
import sys
import threading

from fluentbit_tpu_torch import __version__

USAGE = """\
fluentbit_tpu_torch — the telemetry pipeline on a CUDA card

Options:
  -c, --config FILE     load a configuration file (classic INI or YAML)
  -R, --parser FILE     load a parsers file
  -i, --input NAME      add an input plugin instance
  -F, --filter NAME     add a filter plugin instance
  -o, --output NAME     add an output plugin instance
  -p, --prop K=V        set a property on the last added instance
  -t, --tag TAG         set the tag on the last added input
  -m, --match PATTERN   set the match rule on the last filter/output
  -f, --flush SECONDS   flush interval
  -g, --grace SECONDS   shutdown grace period
  -D, --define K=V      set a config variable for ${K} interpolation
  -v, --verbose         increase log verbosity (repeatable)
  -q, --quiet           decrease log verbosity
  --device DEVICE       cuda (default) or cpu
  --supervisor          run under a supervising parent that restarts
                        the worker on crash
  --dry-run             validate configuration and exit
  -V, --version         print version and exit
  -h, --help            this message

Not ported (each raises by name): -e/--plugin (dynamic plugins),
-H/--http and -P/--port (the admin HTTP server).
"""

#: options of the reference that need what the port does not have
UNPORTED_OPTIONS = {
    "-e": "dynamic (.so) plugins", "--plugin": "dynamic (.so) plugins",
    "-H": "admin HTTP server", "--http": "admin HTTP server",
    "-P": "admin HTTP server", "--port": "admin HTTP server",
}

DEVICES = ("cuda", "cpu")


def _device(argv) -> str:
    """The value of the last ``--device`` (``cuda`` without one)."""
    device = "cuda"
    for j, a in enumerate(argv):
        if a == "--device":
            if j + 1 >= len(argv) or argv[j + 1] not in DEVICES:
                raise SystemExit(f"--device takes one of {DEVICES}")
            device = argv[j + 1]
    return device


def build_context(argv):
    """argv → (ctx, verbosity, dry_run, config_path, env), in the
    reference's order semantics, on the device ``--device`` names (made
    at the first option that needs it, so ``-h`` and ``-V`` need no
    card)."""
    import fluentbit_tpu_torch as flb
    from fluentbit_tpu_torch.config_format import (_apply_parsers,
                                                   apply_to_context,
                                                   load_config_file)

    device = _device(argv)
    made = []  # the context, made at the first option that needs it

    def context():
        if not made:
            made.append(flb.create(device=device))
        return made[0]

    env = {}
    last = None  # (kind, ffd)
    verbosity = 0
    dry_run = False
    config_path = None
    i = 0

    def need_arg(flag):
        nonlocal i
        i += 1
        if i >= len(argv):
            raise SystemExit(f"option {flag} requires an argument")
        return argv[i]

    while i < len(argv):
        a = argv[i]
        if a in ("-h", "--help"):
            print(USAGE)
            raise SystemExit(0)
        elif a in ("-V", "--version"):
            print(f"fluentbit_tpu_torch v{__version__}")
            raise SystemExit(0)
        elif a in UNPORTED_OPTIONS:
            raise SystemExit(f"option {a} is not ported: the port has no "
                             f"{UNPORTED_OPTIONS[a]}")
        elif a == "--device":
            need_arg(a)  # read before the context was created
        elif a in ("-c", "--config"):
            config_path = need_arg(a)
            cf = load_config_file(config_path, env=env)
            apply_to_context(
                context(), cf, os.path.dirname(os.path.abspath(config_path)))
        elif a in ("-R", "--parser"):
            _apply_parsers(context(), load_config_file(need_arg(a), env=env))
        elif a in ("-i", "--input"):
            last = ("input", context().input(need_arg(a)))
        elif a in ("-F", "--filter"):
            last = ("filter", context().filter(need_arg(a)))
        elif a in ("-o", "--output"):
            last = ("output", context().output(need_arg(a)))
        elif a in ("-p", "--prop"):
            kv = need_arg(a)
            if "=" not in kv or last is None:
                raise SystemExit(f"bad -p usage: {kv!r}")
            k, v = kv.split("=", 1)
            context().set(last[1], **{k: v})
        elif a in ("-t", "--tag"):
            if last is None or last[0] != "input":
                raise SystemExit("-t requires a preceding -i")
            context().set(last[1], tag=need_arg(a))
        elif a in ("-m", "--match"):
            if last is None or last[0] == "input":
                raise SystemExit("-m requires a preceding -F/-o")
            context().set(last[1], match=need_arg(a))
        elif a in ("-f", "--flush"):
            context().service_set(flush=need_arg(a))
        elif a in ("-g", "--grace"):
            context().service_set(grace=need_arg(a))
        elif a in ("-D", "--define"):
            kv = need_arg(a)
            if "=" in kv:
                k, v = kv.split("=", 1)
                env[k] = v
        elif a in ("-v", "--verbose"):
            verbosity += 1
        elif a in ("-q", "--quiet"):
            verbosity -= 1
        elif a == "--dry-run":
            dry_run = True
        else:
            raise SystemExit(f"unknown option {a!r} (see --help)")
        i += 1

    return context(), verbosity, dry_run, config_path, env


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        print(USAGE)
        return 1
    if "--supervisor" in argv:
        # before anything resolves a device: only the worker builds a
        # CUDA context (flb_supervisor_run)
        from .supervisor import run_supervised

        worker_argv = [a for a in argv if a != "--supervisor"]
        logging.basicConfig(level=logging.INFO,
                            format="[%(asctime)s] [%(levelname)5s] %(message)s")
        return run_supervised(lambda: main(worker_argv))
    ctx, verbosity, dry_run, config_path, _env = build_context(argv)
    level = {-1: logging.ERROR, 0: logging.INFO, 1: logging.DEBUG}.get(
        max(-1, min(1, verbosity)), logging.INFO)
    logging.basicConfig(
        level=level, format="[%(asctime)s] [%(levelname)5s] %(message)s")
    log = logging.getLogger("flb.cli")

    if not ctx.engine.inputs or not ctx.engine.outputs:
        log.error("configuration needs at least one input and one output")
        return 1
    if dry_run:
        print("configuration test is successful")
        return 0

    stop_evt = threading.Event()
    reload_req = threading.Event()
    # the running context, held in a list so the handlers read the
    # current one after a reload
    current = [ctx]

    def reload_enabled() -> bool:
        # reload is gated (reference: -Y / [SERVICE] Hot_Reload On)
        return bool(config_path) and current[0].engine.service.hot_reload

    def request_reload() -> None:
        reload_req.set()
        stop_evt.set()

    def on_stop(signum, frame):
        stop_evt.set()

    def on_hup(signum, frame):
        if reload_enabled():
            request_reload()
        else:
            log.warning("SIGHUP ignored (hot_reload off or no config file)")

    signal.signal(signal.SIGINT, on_stop)
    signal.signal(signal.SIGTERM, on_stop)
    signal.signal(signal.SIGHUP, on_hup)

    reloads = 0
    while True:
        ctx = current[0]
        if reload_enabled():
            ctx.engine.reload_callback = request_reload
        ctx.engine.reload_count = reloads
        ctx.start()
        log.info("fluentbit_tpu_torch v%s started (pid %d) on %s",
                 __version__, os.getpid(), ctx.device)
        while True:
            while not stop_evt.is_set() and ctx.engine.running:
                stop_evt.wait(0.2)
            if not reload_req.is_set():
                log.info("stopping (grace %ss)...", ctx.engine.service.grace)
                ctx.stop()
                return 0
            if getattr(ctx.engine, "reload_config_path", None):
                raise RuntimeError(
                    "reload onto a fleet-managed config path "
                    "(reload_config_path) is not ported")
            # validate the new configuration, with the whole original
            # argv, before the old pipeline is torn down
            log.info("reloading configuration %s", config_path)
            reload_req.clear()
            stop_evt.clear()
            try:
                new_ctx, *_ = build_context(argv)
                ok = bool(new_ctx.engine.inputs and new_ctx.engine.outputs)
            except (SystemExit, Exception) as e:  # noqa: BLE001
                log.error("reload failed, keeping current pipeline: %s", e)
                continue  # the old engine is still running
            if not ok:
                log.error("reload failed, keeping current pipeline: "
                          "needs at least one input and one output")
                continue
            log.info("stopping old pipeline (grace %ss)...",
                     ctx.engine.service.grace)
            ctx.stop()
            current[0] = new_ctx
            reloads += 1
            break  # the outer loop starts the new context


if __name__ == "__main__":
    sys.exit(main())
