"""Execute the REAL multi-process distributed path once, on 2 CPU processes.

Round-2 verdict: `initialize_from_env` had only ever returned False -- the
True branch (`jax.distributed.initialize`), the
`make_array_from_process_local_data` cross-process assembly and the
per-host shard readback (parallel/distributed.py) were exercised by zero
runs.  This script is the prescribed CPU simulation (SURVEY.md section 4:
simulate before pods): two OS processes, each with 4 virtual CPU devices,
one 8-device global mesh, decoding a 16-image corpus via
`decode_batch_distributed` and asserting every pixel equals the
single-process host decode.

Writes DISTRIBUTED_r*.json at the repo root (run metadata + checksums).

Usage: python scripts/run_distributed_2proc.py [out.json]
       (spawns its own workers; do not run under a jax-initialized process)
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

N_PROC = 2
DEVS_PER_PROC = 4
N_IMAGES = 16
GEOM = (96, 136)  # -> 12x17 luma blocks; odd enough to catch crop bugs
PORT = 53219


def make_corpus():
    from jaxjpeg.testing import corpus

    return [
        corpus.pil_jpeg(
            corpus.synthetic_rgb(*GEOM, seed=300 + i),
            quality=80,
            subsampling="4:2:0",
        )
        for i in range(N_IMAGES)
    ]


def worker(pid: int) -> None:
    # Force the CPU backend BEFORE any device use.
    import jax

    jax.config.update("jax_platforms", "cpu")

    import numpy as np

    from jaxjpeg.parallel import distributed as dist

    ok = dist.initialize_from_env(
        coordinator_address=f"127.0.0.1:{PORT}",
        num_processes=N_PROC,
        process_id=pid,
    )
    assert ok, "initialize_from_env must take the True branch here"
    assert jax.process_count() == N_PROC
    assert jax.device_count() == N_PROC * DEVS_PER_PROC

    datas = make_corpus()
    shard = dist.local_shard(len(datas))
    local = datas[shard]
    t0 = time.perf_counter()
    out = dist.decode_batch_distributed(local, space=2)
    wall = time.perf_counter() - t0
    assert len(out) == len(local)

    # Ground truth: plain single-process host decode of the same images.
    import jaxjpeg as jt

    mism = 0
    shas = []
    for img_bytes, rgb in zip(local, out):
        ref = jt.decode(img_bytes, impl="host")
        if not np.array_equal(rgb, ref):
            mism += 1
        shas.append(hashlib.sha256(np.ascontiguousarray(rgb).tobytes())
                    .hexdigest()[:12])
    result = {
        "process_id": pid,
        "process_count": jax.process_count(),
        "global_devices": jax.device_count(),
        "local_images": len(local),
        "shard": [shard.start, shard.stop],
        "mismatches": mism,
        "rgb_sha": shas,
        "decode_wall_s": round(wall, 2),
    }
    print("WORKER_RESULT " + json.dumps(result), flush=True)
    sys.exit(1 if mism else 0)


def main() -> int:
    out_path = sys.argv[1] if len(sys.argv) > 1 else os.path.join(
        REPO, "DISTRIBUTED_r03.json"
    )
    env = dict(
        os.environ,
        XLA_FLAGS=(
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={DEVS_PER_PROC}"
        ).strip(),
    )
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--worker", str(i)],
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
        )
        for i in range(N_PROC)
    ]
    t0 = time.perf_counter()
    outs = [p.communicate(timeout=900)[0] for p in procs]
    rcs = [p.returncode for p in procs]
    results = []
    for o in outs:
        for line in o.splitlines():
            if line.startswith("WORKER_RESULT "):
                results.append(json.loads(line[len("WORKER_RESULT "):]))
    ok = (
        rcs == [0] * N_PROC
        and len(results) == N_PROC
        and all(r["mismatches"] == 0 for r in results)
        and sum(r["local_images"] for r in results) == N_IMAGES
    )
    artifact = {
        "ok": ok,
        "n_processes": N_PROC,
        "devices_per_process": DEVS_PER_PROC,
        "n_images": N_IMAGES,
        "geometry": list(GEOM),
        "mesh": {"data": 4, "space": 2},
        "return_codes": rcs,
        "wall_s": round(time.perf_counter() - t0, 1),
        "workers": results,
    }
    with open(out_path, "w") as f:
        json.dump(artifact, f, indent=1)
    print(json.dumps(artifact))
    if not ok:
        for o in outs:
            print(o[-2000:], file=sys.stderr)
    return 0 if ok else 1


if __name__ == "__main__":
    if len(sys.argv) >= 3 and sys.argv[1] == "--worker":
        worker(int(sys.argv[2]))
    else:
        raise SystemExit(main())
