"""What the cluster experiment twins share (Exp #5-#8, #13): the Qwen3-32B
pool layout, the LV-Eval-like workload, the two-phase protocol of Exp #5,
and the check of a run's numbers against pinned ones.

Twin of ``benchmarks/common.py:19-79``. ``lveval_requests`` draws its
tokens and arrivals from the same ``numpy.random.default_rng`` and
``random.Random`` seeds in the same order, so both sides serve the same
requests. Nothing here touches a device: the cluster's times are MODELED.
"""

from __future__ import annotations

import math
import random

import numpy as np

from repro_torch.configs.registry import get_config
from repro_torch.core.pool import KVBlockLayout
from repro_torch.serving.request import Request, summarize
from repro_torch.serving.scheduler import Cluster


def qwen32b_layout(block_tokens: int = 16) -> KVBlockLayout:
    """The registry's qwen3-32b: 64 layers, 8 kv heads of 80, 128 fragments
    of 20 KiB a 16-token block (2.5 MiB)."""
    return KVBlockLayout.for_model(get_config("qwen3-32b"), block_tokens)


def lveval_requests(
    n: int,
    in_len: int = 15000,
    out_len: int = 64,
    prefix_frac: float = 0.3,
    rate: float | None = None,
    tag: str = "r",
    arrival0: float = 0.0,
    seed: int = 1,
) -> list[Request]:
    """LV-Eval-like workload: long contexts sharing a ``prefix_frac`` base
    prefix, each request's suffix drawn from its own seed (the same tokens
    in the populate and hit phases), and Poisson arrivals at ``rate``
    (all at ``arrival0`` without one: a closed loop)."""
    cut = int(in_len * prefix_frac)
    base = np.random.default_rng(seed).integers(0, 1000, size=in_len).tolist()
    reqs, t = [], arrival0
    arr_rng = random.Random(seed + 7)
    for i in range(n):
        suffix = np.random.default_rng(1000 + i).integers(0, 1000, size=in_len - cut).tolist()
        reqs.append(Request(req_id=f"{tag}{i}", tokens=base[:cut] + suffix,
                            n_output=out_len, arrival=t))
        if rate:
            t += arr_rng.expovariate(rate)
    return reqs


def run_populate_then_hit(cluster_cfg, layout, n=256, in_len=15000, out_len=64):
    """Exp #5's two phases on one cluster: a populating run, then the same
    prompts again from the last engine's clock. Returns (the populate run's
    stats, the hit phase's summary, the cluster)."""
    c = Cluster(cluster_cfg, layout)
    for r in lveval_requests(n, in_len, out_len):
        c.dispatch(r)
    s1 = c.run()
    t0 = max(e.clock for e in c.engines)
    for r in lveval_requests(n, in_len, out_len, tag="h", arrival0=t0):
        c.dispatch(r)
    c.run()
    hits = [r for r in c.requests if r.req_id.startswith("h")]
    s2 = summarize(hits, max(x.t_done for x in hits) - t0)
    return s1, s2, c


def flat(d: dict, prefix: str = "") -> dict:
    """A nested dict's leaves under dotted keys."""
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def mismatches(got: dict, want: dict, prefix: str = "", rel: float = 1e-12) -> list[str]:
    """Each leaf of ``got`` against ``want``'s: an integer (or any
    non-float) exactly, a float within ``rel`` of it, a list element by
    element. Returns what differs."""
    g, w = flat(got), flat(want)
    if g.keys() != w.keys():
        return [f"{prefix.rstrip('.')}: keys {sorted(g.keys() ^ w.keys())}"]
    bad = []
    for k, wv in w.items():
        gv = g[k]
        pairs = list(zip(gv, wv)) if isinstance(wv, list) and len(gv) == len(wv) else [(gv, wv)]
        same = all(math.isclose(a, b, rel_tol=rel, abs_tol=0.0) if isinstance(b, float)
                   else a == b for a, b in pairs)
        if not same:
            bad.append(f"{prefix}{k}: {gv!r} != pinned {wv!r}")
    return bad
