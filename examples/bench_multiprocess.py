#!/usr/bin/env python
"""True multi-process scaling bench: frames/s at 1 process (1 robot,
1 card) vs N processes (N robots, one card each, jax.distributed over
localhost gRPC) — the "1 host vs N hosts" measurement points of
BASELINE.md, with real cross-process mechanics (global device set)
rather than one process driving every card.

Each worker sees exactly one card through CUDA_VISIBLE_DEVICES, so no
two JAX processes share a card; asking for more workers than visible
cards is an error. This launcher never imports JAX.

Efficiency = fps(N proc, N robots) / (N * fps(1 proc, 1 robot)).
Prints one JSON line. Each configuration runs `multihost_worker.py`
in MRSLAM_BENCH mode.

Run:  python examples/bench_multiprocess.py    (env BENCH_PROCESSES=2)
"""
from __future__ import annotations

import json
import os
import socket
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


def visible_cards() -> list[str]:
    """Card ids this process may hand out: CUDA_VISIBLE_DEVICES when it
    is set, else every card nvidia-smi lists."""
    env = os.environ.get("CUDA_VISIBLE_DEVICES")
    if env is not None:
        return [c for c in env.split(",") if c.strip()]
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=index", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout
    return [c.strip() for c in out.splitlines() if c.strip()]


def worker_env(card: str, n_robots: int, frames: int) -> dict:
    env = dict(os.environ)
    env.pop("PYTEST_CURRENT_TEST", None)
    for k in ("MRSLAM_COORDINATOR", "MRSLAM_NUM_PROCESSES",
              "MRSLAM_PROCESS_ID"):
        env.pop(k, None)
    env.update(
        CUDA_VISIBLE_DEVICES=card,
        MRSLAM_ROBOTS=str(n_robots),
        MRSLAM_FRAMES=str(frames),
        MRSLAM_BENCH="1",
        PYTHONPATH=os.pathsep.join(
            [REPO] + [x for x in env.get("PYTHONPATH", "").split(os.pathsep)
                      if x]),
    )
    return env


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run_config(n_procs: int, frames: int, cards: list[str]) -> float:
    port = _free_port()
    procs = []
    for pid in range(n_procs):
        env = worker_env(cards[pid], n_procs, frames)
        if n_procs > 1:
            env.update(
                MRSLAM_COORDINATOR=f"127.0.0.1:{port}",
                MRSLAM_NUM_PROCESSES=str(n_procs),
                MRSLAM_PROCESS_ID=str(pid),
            )
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(HERE, "multihost_worker.py")],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        ))
    fps = None
    try:
        for p in procs:
            stdout, _ = p.communicate(timeout=1200)
            text = stdout.decode()
            if p.returncode != 0:
                raise RuntimeError(
                    f"worker exited rc={p.returncode}; output tail:\n"
                    + "\n".join(text.splitlines()[-20:])
                )
            for line in text.splitlines():
                if line.startswith("{") and "bench_fps" in line:
                    rec = json.loads(line)
                    fps = rec["bench_fps"]
                    run_config.last_split = rec.get("split_ms")
    finally:
        # a timeout/crash must not leak sibling workers
        for p in procs:
            if p.poll() is None:
                p.kill()
    if fps is None:
        raise RuntimeError("no bench_fps line from workers")
    return fps


def run_concurrent_independent(n_procs: int, frames: int,
                               cards: list[str]) -> float:
    """The HOST ROOF: n fully-independent 1-robot/1-process workers, one
    card each, running simultaneously (no jax.distributed, no
    collectives). Their combined frames/s is the best any n-process
    scheme can do on this host; the gap between it and the distributed
    number is OUR dispatch/coordination overhead, the rest is contention
    for the host's cores."""
    procs = []
    for pid in range(n_procs):
        env = worker_env(cards[pid], 1, frames)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(HERE, "multihost_worker.py")],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        ))
    total = 0.0
    try:
        for p in procs:
            stdout, _ = p.communicate(timeout=1200)
            text = stdout.decode()
            if p.returncode != 0:
                raise RuntimeError(
                    f"worker exited rc={p.returncode}; tail:\n"
                    + "\n".join(text.splitlines()[-20:])
                )
            for line in text.splitlines():
                if line.startswith("{") and "bench_fps" in line:
                    total += json.loads(line)["bench_fps"]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    if total == 0.0:
        raise RuntimeError("no bench_fps lines from concurrent workers")
    return total


def main() -> None:
    n = int(os.environ.get("BENCH_PROCESSES", "2"))
    frames = int(os.environ.get("BENCH_FRAMES", "64"))
    cards = visible_cards()
    if n > len(cards):
        sys.exit(f"bench_multiprocess: {n} workers need {n} cards, "
                 f"{len(cards)} visible")
    fps_1 = run_config(1, frames, cards)
    fps_n = run_config(n, frames, cards)
    split_n = getattr(run_config, "last_split", None)
    fps_roof = run_concurrent_independent(n, frames, cards)
    out = {
        "fps_1proc": round(fps_1, 2),
        "fps_nproc": round(fps_n, 2),
        "fps_cores_roof": round(fps_roof, 2),
        "n_processes": n,
        "frames_per_dispatch": frames,
        "efficiency": round(fps_n / (n * fps_1), 3),
        # efficiency with host CPU contention factored out: distributed
        # throughput vs what n independent processes achieve on the
        # same cores — isolates dispatch/collective overhead
        "efficiency_vs_cores_roof": round(fps_n / fps_roof, 3),
        "cards": cards[:n],
        "cpu_cores": os.cpu_count(),
        "split_ms_nproc": split_n,
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
