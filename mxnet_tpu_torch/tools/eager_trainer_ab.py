"""Time chip_smoke.py's eager-Trainer phases in several checkouts, in
turns, on one card.

    python3 mxnet_tpu_torch/tools/eager_trainer_ab.py [--full] OLD NEW NEW OLD
    python3 mxnet_tpu_torch/tools/eager_trainer_ab.py --phases resnet_train \
        OLD NEW NEW OLD

Each argument is the root of a checkout of this repository (with its
``chip_smoke.py``). Each runs in a process of its own, from its root:
the card's name and power limit, the kernels' build, then the
``bert_trainer`` phase (BERT-base bf16, Trainer + LAMB, (32, 512)) and
the ``resnet_v2_trainer`` phase (resnet50_v2 bf16, Trainer + NAG, 128 x
224), each with its own checks (``--phases a,b`` names other phases of
``chip_smoke.py`` to run instead, e.g. ``resnet_train``); with
``--full``, the whole of
``chip_smoke.py`` instead, so that the two phases run after every phase
before them, as in a whole run. Two versions of the port are compared in
one call this way; give them in the order old, new, new, old so that a
drift of the card over the call shows. Prints one JSON line per run
(ms per step, the host ms of the forward, backward and
``Trainer.step``, medians over the timed steps, where the phase reports
them, and its device ms by kind, where it profiles a step) and a last
line with every run; exits non-zero if a run failed. Needs one CUDA
card.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

_RUN = """
import sys
sys.path.insert(0, {root!r})
import chip_smoke as c
c.phase_device()
c.phase_build()
for name in {phases!r}:
    getattr(c, "phase_" + name)()
"""

# the whole run, with the resnet_v2_trainer phase watched from outside:
# what the process holds when it starts (Python objects, threads, device
# memory), the garbage collector's pauses during it, the device's kernels
# in its second warm-up step (torch.profiler) and the host's Python in its
# third (cProfile); warm-up steps are untimed
_RUN_FULL = """
import sys
sys.path.insert(0, {root!r})
import importlib.util
import chip_smoke as c
spec = importlib.util.spec_from_file_location("eager_trainer_ab", {tool!r})
tool = importlib.util.module_from_spec(spec)
spec.loader.exec_module(tool)
tool.watch_resnet_v2(c, {root!r})
c.main()
"""


def watch_resnet_v2(c, root: str) -> None:
    """Wrap ``c.phase_resnet_v2_trainer`` (``c`` a chip_smoke module) so
    that it prints a ``resnet_v2_trainer_host`` line after it runs."""
    import cProfile
    import gc
    import pstats
    import threading
    import time

    import torch

    phase, step = c.phase_resnet_v2_trainer, c._eager_step
    st = {"on": False, "n": 0, "prof": None, "gc_ms": 0.0, "gc_n": [0] * 3,
          "t": 0.0, "device": None}

    def gc_cb(when, info):
        if when == "start":
            st["t"] = time.perf_counter()
        else:
            st["gc_ms"] += (time.perf_counter() - st["t"]) * 1e3
            st["gc_n"][info["generation"]] += 1

    def watched_step(*a, **k):
        if st["on"]:
            st["n"] += 1
            if st["n"] == 2:
                from torch.profiler import ProfilerActivity, profile

                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    r = step(*a, **k)
                    torch.cuda.synchronize()
                st["device"] = _device_kernels(prof)
                return r
            if st["n"] == 3:
                st["prof"] = cProfile.Profile()
                st["prof"].enable()
                try:
                    return step(*a, **k)
                finally:
                    st["prof"].disable()
        return step(*a, **k)

    def watched_phase():
        out = {"phase": "resnet_v2_trainer_host",
               "loadavg_before": os.getloadavg(),
               "cpus": len(os.sched_getaffinity(0)),
               "torch_threads": torch.get_num_threads(),
               "objects": len(gc.get_objects()),
               "threads": sorted(t.name for t in threading.enumerate()),
               "cuda_allocated_gib": torch.cuda.memory_allocated() / 2 ** 30,
               "cuda_reserved_gib": torch.cuda.memory_reserved() / 2 ** 30}
        st["on"] = True
        gc.callbacks.append(gc_cb)
        wall, cpu = time.perf_counter(), time.process_time()
        try:
            return phase()
        finally:
            gc.callbacks.remove(gc_cb)
            st["on"] = False
            out.update(gc_ms=st["gc_ms"], gc_collections=st["gc_n"],
                       step2_device=st["device"],
                       wall_s=time.perf_counter() - wall,
                       process_cpu_s=time.process_time() - cpu,
                       loadavg_after=os.getloadavg())
            if st["prof"] is not None:
                ps = pstats.Stats(st["prof"])
                rows = sorted(ps.stats.items(), key=lambda kv: -kv[1][2])
                out["step3_profile"] = {
                    "calls": ps.total_calls, "seconds": ps.total_tt,
                    "top": [[f"{f.replace(root, '')}:{n}", nc, tt]
                            for (f, _, n), (_, nc, tt, _, _) in rows[:25]]}
            print(json.dumps(out), flush=True)

    c.phase_resnet_v2_trainer = watched_phase
    c._eager_step = watched_step

_PHASES = ("bert_trainer", "resnet_v2_trainer")


def _host(d: dict):
    if "host_ms_median" in d:
        h = d["host_ms_median"]
        return {"forward": h["forward"], "backward": h["backward"],
                "trainer_step": h["trainer_step"]}
    if "host_ms_forward" not in d:
        return None
    return {"forward": d["host_ms_forward"],
            "backward": d["host_ms_backward"],
            "trainer_step": d["host_ms_trainer_step"]}


def _device_kernels(prof) -> dict:
    """The device time of a profiled region: the sum of every kernel's
    own time, their count, and the 12 longest by total."""
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            rows.append((e.key[:90], e.count, us))
    rows.sort(key=lambda r: -r[2])
    return {"device_ms": sum(r[2] for r in rows) / 1e3,
            "kernels": sum(r[1] for r in rows),
            "top": [[k, n, us / 1e3] for k, n, us in rows[:12]]}


def run_tree(root: str, full: bool = False, phases=_PHASES,
             timeout: float = 1200.0) -> dict:
    """One checkout's phases in a fresh process."""
    root = os.path.abspath(root)
    code = (_RUN_FULL if full else _RUN).format(
        root=root, tool=os.path.abspath(__file__), phases=tuple(phases))
    p = subprocess.run([sys.executable, "-c", code], cwd=root,
                       capture_output=True, text=True, timeout=timeout)
    out = {"tree": root, "full": full, "rc": p.returncode}
    for line in p.stdout.splitlines():
        if not line.startswith("{"):
            continue
        d = json.loads(line)
        if d.get("phase") == "device":
            out["card"] = d["card"]
        elif d.get("phase") == "resnet_v2_trainer_host":
            out["resnet_v2_trainer_host"] = d
        elif d.get("phase") in phases and "settings" in d:
            # llama_remat: ms per step in each remat setting
            out[d["phase"]] = {k: v["ms_per_step"]
                               for k, v in d["settings"].items()}
        elif d.get("phase") in phases:
            out[d["phase"]] = {
                "ms_per_step": d["ms_per_step"], "host_ms": _host(d),
                "device_ms_by_kind": d.get("step_breakdown", {}).get(
                    "device_ms_per_step_by_kind")}
    if p.returncode != 0:
        out["stderr_tail"] = p.stderr[-2000:]
    return out


def main(argv) -> int:
    argv = list(argv)
    full = "--full" in argv
    phases = _PHASES
    if "--phases" in argv:
        i = argv.index("--phases")
        phases = tuple(argv[i + 1].split(","))
        del argv[i:i + 2]
    roots = [a for a in argv if a != "--full"]
    if not roots:
        print(__doc__, file=sys.stderr)
        return 2
    runs = []
    for root in roots:
        r = run_tree(root, full, phases)
        print(json.dumps(r), flush=True)
        runs.append(r)
    print(json.dumps({"runs": runs}), flush=True)
    return 0 if all(r["rc"] == 0 for r in runs) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
