"""Time the record-file readers on a token file of the pretraining
driver's shape.

    python3 -m mxnet_tpu_torch.tools.recordio_bench [--gib 1.0] [--dir D]

Writes ``--gib`` GiB of records of 2049 seeded int32 ids (the shape that
``tools/pretrain_llama.py --data`` reads at seq 2048) under ``--dir``
(default ``build/recordio_bench`` at the repository root), then reads
the whole file in turns with the native reader (``_native/recordio.cpp``)
and the pure-Python one (``recordio._PlainRecordIO``'s), native, plain,
plain, native:

* ``scan``: ``MXRecordIO.read()`` of every record: records/s and MB/s;
  also over a second file of ``--small`` records of 64 bytes (a file of
  labels or short features), where the cost per record shows;
* ``batches``: the driver's ``_record_batches`` at batch 8 x seq 2048 on
  the host (the pinned copy to the card left out): ms per batch, to
  hold against a training step's time.

The file was just written, so every read is warm (from the page cache).
Prints the card's name and power limit (the host is the card's
machine's), one JSON line per read and a last line with them all; the
file is removed at the end.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch


def _root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def main(argv=None) -> int:
    from mxnet_tpu_torch.recordio import MXRecordIO
    from mxnet_tpu_torch.tools.pretrain_llama import _record_batches

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--gib", type=float, default=1.0)
    ap.add_argument("--small", type=int, default=1_000_000)
    ap.add_argument("--dir", default=os.path.join(_root(), "build",
                                                  "recordio_bench"))
    args = ap.parse_args(argv)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip() if shutil.which("nvidia-smi") else "none"
    print(card, flush=True)
    seq, batch, rec_bytes = 2048, 8, 2049 * 4
    n = int(args.gib * 2 ** 30) // rec_bytes
    os.makedirs(args.dir, exist_ok=True)
    path = os.path.join(args.dir, "tokens.rec")
    rs = np.random.RandomState(0)
    t0 = time.perf_counter()
    w = MXRecordIO(path, "w")
    for start in range(0, n, 4096):
        ids = rs.randint(0, 32768, (min(4096, n - start), 2049),
                         dtype=np.int32)
        for row in ids:
            w.write(row.tobytes())
    w.close()
    size = os.path.getsize(path)
    runs = [{"what": "write", "records": n, "bytes": size,
             "seconds": time.perf_counter() - t0}]
    small = os.path.join(args.dir, "small.rec")
    w = MXRecordIO(small, "w")
    rec = rs.bytes(64)
    for _ in range(args.small):
        w.write(rec)
    w.close()
    print(json.dumps(runs[0]), flush=True)

    def scan(file, count):
        r = MXRecordIO(file, "r")
        t0 = time.perf_counter()
        got = 0
        while r.read() is not None:
            got += 1
        dt = time.perf_counter() - t0
        r.close()
        assert got == count, (got, count)
        return {"what": "scan", "reader": name, "records": got,
                "record_bytes": os.path.getsize(file) // got - 8,
                "seconds": dt, "records_per_s": got / dt,
                "mb_per_s": os.path.getsize(file) / dt / 1e6, "card": card}

    try:
        for native in (True, False, False, True):
            MXRecordIO._native = native
            name = "native" if native else "plain"
            for file, count in ((path, n), (small, args.small)):
                runs.append(scan(file, count))
                print(json.dumps(runs[-1]), flush=True)
            data = _record_batches(path, batch, seq, torch.device("cpu"))
            nb = n // batch
            t0 = time.perf_counter()
            for _ in range(nb):
                next(data)
            dt = time.perf_counter() - t0
            data.close()
            bat = {"what": "batches", "reader": name, "batches": nb,
                   "batch": [batch, seq], "seconds": dt,
                   "ms_per_batch": dt * 1e3 / nb, "card": card}
            print(json.dumps(bat), flush=True)
            runs.append(bat)
    finally:
        MXRecordIO._native = True
        shutil.rmtree(args.dir, ignore_errors=True)
    print(json.dumps({"runs": runs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
