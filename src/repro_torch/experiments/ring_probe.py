"""What the ring's server threads cost an engine in the same process.

A ``RingServer`` thread and the engine's host-bound decode share one
interpreter lock: each aten call the engine makes hands the GIL back and
forth, and a server thread that spins (``time.sleep(0)``, the reference's
thread transport) takes it in between. This probe serves Llama-3.1-8B
(full width on the card; ``--cpu`` a reduced config) and measures, in
turns on one engine and one pool:

  * a full hit's TTFT with its index in process, behind one ring and behind
    four (``core/wire.ring_plane``: servers parked on their doorbells);
  * a decode step's host time with no server thread, beside four parked
    servers, and beside one spinning (a ``RingServer`` without a doorbell).

Medians of ``--turns`` turns, host clock (``time.perf_counter``; decode
steps synchronised on the card). One JSON line.

    python -m repro_torch.experiments.ring_probe [--turns 8] [--cpu]
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import numpy as np
import torch

from repro_torch.configs.registry import get_config, reduced_config
from repro_torch.core.index import PrefixIndex, ShardedPrefixIndex
from repro_torch.core.rpc import RingServer, SlotRing
from repro_torch.core.wire import make_index_handler, ring_plane
from repro_torch.experiments import ring_serve as rs
from repro_torch.serving.real_runner import RealEngine


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _decode_ms(eng, cache, start: int, steps: int) -> float:
    """Median host ms of one decode step (positions from ``start``)."""
    out = []
    for i in range(steps):
        t0 = time.perf_counter()
        eng._decode(cache, 7 + i, start + i)
        _sync(eng.device)
        out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out)


def _plane(pool, n: int):
    return ring_plane(ShardedPrefixIndex(pool, n) if n > 1 else PrefixIndex(pool),
                      rs.N_SLOTS, rs.PAYLOAD)


def run(turns: int = 8, cpu: bool = False) -> dict:
    cfg = reduced_config("llama3.1-8b") if cpu else get_config("llama3.1-8b")
    prompt_len, max_len = (64, 96) if cpu else (1024, 2048)
    eng = RealEngine.create(cfg, max_len=max_len, pool_blocks=64 if cpu else 512, seed=0,
                            device="cpu" if cpu else None)
    rng = np.random.default_rng(1)
    hits = [rng.integers(0, cfg.vocab_size, size=prompt_len).tolist() for _ in range(2)]
    pool = rs.fresh_pool(eng)
    planes = {}
    try:
        for n in (1, 4):
            planes[n] = _plane(pool, n)
        eng.index = planes[1].backing
        for p in hits:  # cold: prefill and publish, then the same entries on 4 rings
            eng.generate(p, max_new=1)
        keys = [k for p in hits for k in eng.index.keys_for(p)]
        ents = eng.index.lookup_many(keys)
        planes[4].backing.publish_many(keys, [e.block_id for e in ents],
                                       [e.epoch for e in ents], pool.layout.block_tokens)
        cells = [("in_process", planes[1].backing), ("rings1", planes[1].remote),
                 ("rings4", planes[4].remote)]
        ttft: dict[str, list[float]] = {}
        for _ in range(turns):
            for name, index in cells:
                eng.index = index
                for p in hits:
                    _, info = eng.generate(p, max_new=1)
                    assert info["hit_tokens"] == prompt_len
                    ttft.setdefault(name, []).append(info["ttft_s"] * 1e3)
    finally:
        for pl in planes.values():
            pl.close()
    # a decode step beside no server, four parked, one spinning
    cache = eng.prefill(hits[0])[1]
    decode: dict[str, list[float]] = {}
    steps = 8 if cpu else 32
    for _ in range(max(2, turns // 4)):
        decode.setdefault("no_server", []).append(_decode_ms(eng, cache, prompt_len, steps))
        parked = _plane(pool, 4)
        try:
            time.sleep(0.01)
            decode.setdefault("four_parked", []).append(_decode_ms(eng, cache, prompt_len, steps))
        finally:
            parked.close()
        spinning = RingServer(SlotRing(rs.N_SLOTS, rs.PAYLOAD),
                              make_index_handler(parked.backing.shards[0])).start()
        try:
            decode.setdefault("one_spinning", []).append(_decode_ms(eng, cache, prompt_len, steps))
        finally:
            spinning.stop()
    out = {"hit_ttft_ms": {k: statistics.median(v) for k, v in ttft.items()},
           "decode_step_ms": {k: statistics.median(v) for k, v in decode.items()},
           "turns": turns, "device": str(eng.device)}
    if not cpu:
        out["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip()
    return out


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--turns", type=int, default=8)
    ap.add_argument("--cpu", action="store_true", help="a reduced config on the CPU")
    args = ap.parse_args(argv)
    out = run(args.turns, args.cpu)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
