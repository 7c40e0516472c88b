#!/usr/bin/env python
"""Supervised multi-process launcher of the port (its own copy of the
reference's ``tools/launch.py:82-421``, which is framework-neutral;
reference MXNet: ``tools/launch.py`` + dmlc_tracker).

Every worker runs the same program; the launcher exports the rendezvous
contract (the ``DMLC_*`` names the reference's trainers read), fans the
command out and supervises it:

* **Poll-based wait.** All workers are polled together (never a serial
  ``p.wait()`` on rank 0 while rank 3 is already dead and its siblings
  hang in a collective).
* **Fail-fast mode** (default, ``--max-restarts 0``): the first worker
  to exit non-zero SIGTERMs the rest, escalating to SIGKILL after
  ``--term-window`` seconds, and the launcher exits with the first
  failing rank's code (signal deaths map to ``128+signum``).
* **Restart mode** (``--max-restarts N``): a dead rank is respawned with
  the same ``DMLC_WORKER_ID`` after a bounded exponential backoff
  (``--restart-backoff``, doubling per restart of that rank, capped at
  30 s), up to N times per rank; exhausted restarts fall back to
  fail-fast.
* **Preemption is not failure.** A worker exiting with ``--preempt-rc``
  (default 75) is respawned with a flat ``--restart-backoff`` delay and
  does not burn the ``--max-restarts`` budget; ``--max-preempt-restarts``
  (default 100) bounds runaway preempt-exit loops. Both advance the
  worker's ``MXNET_ELASTIC_RESTART`` incarnation.
* **Interrupting the supervisor does not orphan the job.** SIGTERM/SIGINT
  are forwarded to every worker, reaped with the same escalation window;
  the exit report (and ``--report`` JSON) is still written and the
  launcher exits ``128+signum``.
* **Structured exit report.** A per-worker table (rank, restarts, every
  exit code/signal) on stdout and, with ``--report PATH``, as JSON.

Local mode (this machine, ``-n`` workers; a CPU job over gloo, or one
card per worker over NCCL)::

    python -m mxnet_tpu_torch.tools.launch -n 4 python train.py

Multi-host mode (``-H hostfile``, one line per host; passwordless ssh, as
the reference's ssh launcher)::

    python -m mxnet_tpu_torch.tools.launch -n 8 -H hosts python train.py

Caveat (shared with the reference's ssh launcher): signals reach the
local ssh client, not the remote python, so a fail-fast teardown of an
ssh-mode rank can orphan the remote process; its own bounded barriers
(``MXNET_KV_BARRIER_TIMEOUT``) fence it.

Workers read ``DMLC_PS_ROOT_URI`` / ``DMLC_PS_ROOT_PORT`` (the
rendezvous address, served by rank 0), ``DMLC_NUM_WORKER`` and
``DMLC_WORKER_ID``: ``mxnet_tpu_torch.kvstore.create('dist_sync')``
joins the job from exactly these. ``MXNET_ELASTIC_COORD_DIR`` (a shared
directory) and ``MXNET_ELASTIC_RESTART`` (this incarnation's restart
count) are exported as well.
"""
from __future__ import annotations

import argparse
import json
import os
import shlex
import signal
import socket
import subprocess
import sys
import tempfile
import time

_BACKOFF_CAP_S = 30.0


def _free_port():
    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]


def _signal_name(signum: int) -> str:
    try:
        return signal.Signals(signum).name
    except ValueError:
        return f"signal {signum}"


def _exit_code(returncode: int) -> int:
    """Shell convention: a signal death (Popen returncode -N) is 128+N."""
    return 128 - returncode if returncode < 0 else returncode


class _Worker:
    """One rank's supervision record: how to (re)spawn it, the live
    process handle, and the full exit history for the report."""

    def __init__(self, rank: int, spawn):
        self.rank = rank
        self._spawn = spawn
        self.proc: subprocess.Popen | None = None
        self.restarts = 0          # failure restarts (--max-restarts)
        self.preemptions = 0       # preempt-rc respawns (separate budget)
        self.exits: list[dict] = []
        self.done = False          # exited 0 — never restarted
        self.restart_at: float | None = None   # pending respawn time

    def spawn(self):
        # the incarnation counter covers BOTH budgets: a worker names
        # per-incarnation artifacts (loss logs, reports) by
        # MXNET_ELASTIC_RESTART and a preemption respawn is a new
        # incarnation exactly like a failure restart
        self.proc = self._spawn(self.rank,
                                self.restarts + self.preemptions)
        self.restart_at = None

    def poll(self):
        """Returncode if the live process has exited, else None."""
        return self.proc.poll() if self.proc is not None else None

    def record_exit(self, returncode: int):
        self.exits.append({"returncode": returncode,
                           "exit_code": _exit_code(returncode),
                           "signal": _signal_name(-returncode)
                           if returncode < 0 else None,
                           "time_unix": time.time()})
        self.proc = None

    def report(self) -> dict:
        return {"rank": self.rank, "restarts": self.restarts,
                "preemptions": self.preemptions,
                "done": self.done, "exits": self.exits,
                "final": self.exits[-1]["exit_code"] if self.exits
                else None}


def _terminate_all(workers, term_window: float):
    """SIGTERM every live worker, escalate to SIGKILL after the bounded
    window — a worker ignoring SIGTERM (or wedged in a dead collective)
    cannot wedge the launcher."""
    live = []
    for w in workers:
        if w.proc is None:
            continue
        rc = w.proc.poll()
        if rc is not None:
            # died between the supervision poll and teardown: reap and
            # record it, or the exit report would claim it never exited
            w.record_exit(rc)
            if rc == 0:
                w.done = True
        else:
            live.append(w)
    for w in live:
        try:
            w.proc.send_signal(signal.SIGTERM)
        except OSError:
            pass
    deadline = time.monotonic() + max(0.0, term_window)
    for w in live:
        remaining = deadline - time.monotonic()
        try:
            w.proc.wait(timeout=max(0.05, remaining))
        except subprocess.TimeoutExpired:
            try:
                w.proc.kill()
            except OSError:
                pass
            w.proc.wait()
    for w in live:
        if w.proc is not None:
            w.record_exit(w.proc.returncode)


def _print_report(workers, out=sys.stderr):
    print("[launch] worker exit report:", file=out)
    for w in workers:
        attempts = []
        for e in w.exits:
            attempts.append(e["signal"] or f"exit {e['exit_code']}")
        print(f"[launch]   rank {w.rank}: "
              f"{' -> restart -> '.join(attempts) or 'never exited'}"
              f" (restarts: {w.restarts}, preemptions: "
              f"{w.preemptions})", file=out)


class _SupervisorSignal:
    """Signal latch for the supervision loop: the handler only records
    the signum (async-signal-safe), the loop acts on it — forwarding
    the teardown to the workers through the normal escalation path
    instead of dying and orphaning them."""

    def __init__(self):
        self.signum: int | None = None
        self._old: dict[int, object] = {}

    def install(self, signals=(signal.SIGTERM, signal.SIGINT)):
        for sig in signals:
            try:
                self._old[int(sig)] = signal.signal(
                    sig, lambda signum, frame:
                    setattr(self, "signum", signum))
            except ValueError:
                # not the main thread (supervise() driven from a test
                # harness thread): run unhandled, the loop still works
                pass
        return self

    def restore(self):
        old, self._old = self._old, {}
        for sig, handler in old.items():
            try:
                signal.signal(sig, handler)
            except (ValueError, TypeError, OSError):
                pass


def supervise(workers, *, max_restarts: int, restart_backoff: float,
              term_window: float, poll_interval: float,
              preempt_rc: int = 75, max_preempt_restarts: int = 100,
              log=lambda msg: print(msg, file=sys.stderr)) -> int:
    """The supervision loop (importable for tests). Spawns every worker,
    polls them all, applies the fail-fast / elastic / preemption policy,
    and returns the job's exit code (first failing rank's code, 0 when
    every rank finished clean). An exit with ``preempt_rc`` (<=0
    disables) is a graceful preemption leave: respawned with a flat
    backoff against its own ``max_preempt_restarts`` budget, the
    failure budget untouched — even a ``--max-restarts 0`` fail-fast
    job rides out preemptions. SIGTERM/SIGINT at the supervisor tears
    the job down (forwarded SIGTERM, SIGKILL escalation) and returns
    ``128+signum`` — the caller still writes its report."""
    interrupt = _SupervisorSignal().install()
    for w in workers:
        w.spawn()
    first_fail: int | None = None
    try:
        while True:
            if interrupt.signum is not None:
                log(f"[launch] supervisor got "
                    f"{_signal_name(interrupt.signum)}; terminating "
                    f"workers (window {term_window:g}s)")
                _terminate_all(workers, term_window)
                return 128 + interrupt.signum
            now = time.monotonic()
            for w in workers:
                if w.done or w.proc is None:
                    # pending restart?
                    if (not w.done and w.restart_at is not None
                            and now >= w.restart_at):
                        log(f"[launch] restarting rank {w.rank} "
                            f"(restart #{w.restarts})")
                        w.spawn()
                    continue
                rc = w.poll()
                if rc is None:
                    continue
                w.record_exit(rc)
                if rc == 0:
                    w.done = True
                    continue
                code = _exit_code(rc)
                desc = _signal_name(-rc) if rc < 0 else f"code {rc}"
                if preempt_rc > 0 and code == preempt_rc and \
                        w.preemptions < max_preempt_restarts:
                    # graceful preemption leave: the worker checkpointed
                    # and asked to be respawned. Flat backoff (the
                    # doubling is for FAILING workers; a preempted one
                    # is healthy) and no failure-budget spend.
                    w.preemptions += 1
                    delay = min(restart_backoff, _BACKOFF_CAP_S)
                    w.restart_at = now + delay
                    log(f"[launch] rank {w.rank} preempted (rc "
                        f"{preempt_rc}); respawn "
                        f"#{w.preemptions}/{max_preempt_restarts} "
                        f"in {delay:.1f}s (restart budget untouched)")
                    continue
                if w.restarts < max_restarts:
                    w.restarts += 1
                    delay = min(
                        restart_backoff * (2.0 ** (w.restarts - 1)),
                        _BACKOFF_CAP_S)
                    w.restart_at = now + delay
                    log(f"[launch] rank {w.rank} died ({desc}); "
                        f"restart #{w.restarts}/{max_restarts} "
                        f"in {delay:.1f}s")
                else:
                    mode = "fail-fast" if max_restarts == 0 else \
                        "restarts exhausted"
                    log(f"[launch] rank {w.rank} died ({desc}); {mode}: "
                        f"terminating remaining workers "
                        f"(window {term_window:g}s)")
                    first_fail = code
                    break
            if first_fail is not None:
                _terminate_all(workers, term_window)
                return first_fail
            if all(w.done for w in workers):
                return 0
            time.sleep(poll_interval)
    except KeyboardInterrupt:
        # reachable only when the SIGINT handler could not be installed
        # (non-main thread): same teardown, conventional 130
        log("[launch] interrupted; terminating workers")
        _terminate_all(workers, term_window)
        return 130
    finally:
        interrupt.restore()


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("-n", "--num-workers", type=int, required=True,
                    help="total worker processes")
    ap.add_argument("-H", "--hostfile", default=None,
                    help="one host per line; default: all workers local")
    ap.add_argument("-p", "--port", type=int, default=0,
                    help="coordinator port (default: pick a free one)")
    ap.add_argument("--env", action="append", default=[],
                    metavar="K=V", help="extra env to export to workers")
    ap.add_argument("--max-restarts", type=int, default=0,
                    help="per-rank restart budget (0 = fail-fast: first "
                    "non-zero exit tears the job down)")
    ap.add_argument("--restart-backoff", type=float, default=1.0,
                    help="base restart delay (s); doubles per restart "
                    f"of a rank, capped at {_BACKOFF_CAP_S:g}s")
    ap.add_argument("--preempt-rc", type=int, default=75,
                    help="exit code meaning 'gracefully preempted, "
                    "respawn me' (0 "
                    "disables preemption handling)")
    ap.add_argument("--max-preempt-restarts", type=int, default=100,
                    help="per-rank preemption respawn budget (separate "
                    "from --max-restarts; preemptions are not failures)")
    ap.add_argument("--term-window", type=float, default=10.0,
                    help="seconds between SIGTERM and SIGKILL when "
                    "tearing the job down")
    ap.add_argument("--poll-interval", type=float, default=0.2,
                    help="supervision poll period (s)")
    ap.add_argument("--coord-dir", default=None,
                    help="shared elastic coordinator dir exported as "
                    "MXNET_ELASTIC_COORD_DIR (default: a fresh tempdir)")
    ap.add_argument("--report", default=None,
                    help="write the per-worker exit report JSON here")
    ap.add_argument("command", nargs=argparse.REMAINDER,
                    help="worker command")
    args = ap.parse_args(argv)
    if not args.command:
        ap.error("no worker command given")
    if args.max_restarts < 0:
        ap.error("--max-restarts must be >= 0")
    if args.max_preempt_restarts < 0:
        ap.error("--max-preempt-restarts must be >= 0")
    cmd = args.command[1:] if args.command[0] == "--" else args.command

    hosts = None
    if args.hostfile:
        with open(args.hostfile) as f:
            hosts = [ln.strip() for ln in f if ln.strip()
                     and not ln.startswith("#")]
        if not hosts:
            ap.error(f"hostfile {args.hostfile} is empty")

    root_uri = hosts[0] if hosts else "127.0.0.1"
    port = args.port or _free_port()
    extra = dict(kv.split("=", 1) for kv in args.env)
    coord_dir = args.coord_dir or tempfile.mkdtemp(prefix="mxnet_elastic_")
    os.makedirs(coord_dir, exist_ok=True)

    def spawn(rank: int, restart_count: int) -> subprocess.Popen:
        env = dict(os.environ, **extra,
                   DMLC_PS_ROOT_URI=root_uri,
                   DMLC_PS_ROOT_PORT=str(port),
                   DMLC_NUM_WORKER=str(args.num_workers),
                   DMLC_WORKER_ID=str(rank),
                   DMLC_ROLE="worker",
                   MXNET_ELASTIC_COORD_DIR=coord_dir,
                   MXNET_ELASTIC_RESTART=str(restart_count))
        if hosts:
            host = hosts[rank % len(hosts)]
            exports = " ".join(
                f"{k}={shlex.quote(env[k])}"
                for k in ("DMLC_PS_ROOT_URI", "DMLC_PS_ROOT_PORT",
                          "DMLC_NUM_WORKER", "DMLC_WORKER_ID",
                          "DMLC_ROLE", "MXNET_ELASTIC_COORD_DIR",
                          "MXNET_ELASTIC_RESTART", *extra))
            remote = f"cd {shlex.quote(os.getcwd())} && " \
                     f"env {exports} {' '.join(map(shlex.quote, cmd))}"
            return subprocess.Popen(["ssh", "-o", "BatchMode=yes", host,
                                     remote])
        return subprocess.Popen(cmd, env=env)

    workers = [_Worker(rank, spawn) for rank in range(args.num_workers)]
    rc = supervise(workers, max_restarts=args.max_restarts,
                   restart_backoff=args.restart_backoff,
                   term_window=args.term_window,
                   poll_interval=args.poll_interval,
                   preempt_rc=args.preempt_rc,
                   max_preempt_restarts=args.max_preempt_restarts)
    _print_report(workers)
    if args.report:
        with open(args.report, "w") as f:
            json.dump({"rc": rc,
                       "mode": "elastic" if args.max_restarts else
                       "fail_fast",
                       "max_restarts": args.max_restarts,
                       "preempt_rc": args.preempt_rc,
                       "max_preempt_restarts": args.max_preempt_restarts,
                       "coord_dir": coord_dir,
                       "workers": [w.report() for w in workers]},
                      f, indent=1)
    return rc


if __name__ == "__main__":
    sys.exit(main())
