"""Pool walkthrough on the port: allocator, coherence epochs, CXL-RPC,
transfers.

Twin of ``examples/pool_demo.py``: gather-write two prompt blocks into the
pool and publish them, match and scatter-read them back bit for bit, match
the same chain over a CXL-RPC ring in one round trip, then recycle a block
and watch a coherent reader refuse its stale epoch. The payload lives on
the card (``--device cpu`` for the CPU); the round trip it prints beside
RDMA's is MODELED.

    PYTHONPATH=src python -m repro_torch.examples.pool_demo [--device cpu]
"""

from __future__ import annotations

import argparse

import torch

from repro_torch import resolve_device
from repro_torch.core.coherence import CoherentBlockReader, StaleEpochError
from repro_torch.core.index import PrefixIndex
from repro_torch.core.pool import KVBlockLayout, KVBlockPool
from repro_torch.core.rpc import RingClient, RingServer, SlotRing
from repro_torch.core.transfer import PoolTransfer
from repro_torch.core.wire import RemoteIndex, make_index_handler


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="default: cuda")
    dev = resolve_device(ap.parse_args(argv).device)
    layout = KVBlockLayout(block_tokens=16, n_layers_kv=8, n_kv_heads=4, head_dim=32)
    pool = KVBlockPool(layout, 128, dev, n_shards=16)
    index = PrefixIndex(pool)
    xfer = PoolTransfer(pool, mode="beluga")
    print(f"pool: 128 blocks x {layout.block_bytes // 1024} KiB over 16 shards "
          f"({layout.n_fragments} fragments/block) on {dev}")

    # writer: gather-write two prompt blocks, then publish them
    prompt = list(range(32))
    blocks = pool.allocate(2)
    gen = torch.Generator(device=dev).manual_seed(0)
    kv = torch.randn((2, *layout.block_shape), generator=gen, device=dev).to(pool.data.dtype)
    epochs = xfer.gather_write(blocks, kv)
    for key, b, e in zip(index.keys_for(prompt), blocks, epochs):
        index.publish(key, b, e, 16)
    print(f"writer: packed 2 blocks ({2 * layout.n_fragments} fragments) in "
          f"{xfer.stats.requests_issued} fused transfer; published")
    print(f"shard occupancy (interleaved): {pool.shard_occupancy()}")

    # reader: prefix match, then an epoch-checked scatter-read
    hits = index.match_prefix(prompt + [99] * 16)
    got = xfer.scatter_read([b for _, b, _ in hits], [e for _, _, e in hits])
    assert torch.equal(got, kv)
    print(f"reader: matched {len(hits)} blocks, payload bit-exact")

    # CXL-RPC: the index behind a ring served by a thread, in the wire codec
    ring = SlotRing(n_slots=32, payload_bytes=4096)
    server = RingServer(ring, make_index_handler(index, max_reply=ring.payload_bytes)).start()
    client = RingClient(ring)
    try:
        remote_hits = RemoteIndex(client, block_tokens=16).match_prefix(prompt)
    finally:
        server.stop()
    assert remote_hits == hits  # the same chain, the same answer
    print(f"CXL-RPC match_prefix -> {len(remote_hits)} blocks in {client.stats.requests} round "
          f"trip (MODELED RTT {client.modeled_rtt() * 1e6:.2f} us vs RDMA-RC 8.39 us)")

    # coherence: recycling a block invalidates a reader holding its epoch
    reader = CoherentBlockReader(pool)
    _, bid, epoch = hits[0]
    pool.retain([bid])
    pool.release([bid])
    pool.release([bid])  # refcount 0: recycled, epoch bumped
    try:
        reader.read_block(bid, epoch)
        print("ERROR: stale read went undetected")
    except StaleEpochError as e:
        print(f"coherence: stale read rejected ({e})")
    assert len(index.match_prefix(prompt)) == 0  # the stale entry is dropped too


if __name__ == "__main__":
    main()
