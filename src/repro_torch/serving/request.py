"""Request lifecycle objects + metrics: twin of ``repro/serving/request.py``."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class Request:
    req_id: str
    tokens: list[int]
    n_output: int
    arrival: float = 0.0
    # lifecycle
    state: str = "queued"  # queued | running | done
    t_admitted: float | None = None
    t_first_token: float | None = None
    t_done: float | None = None
    tokens_out: int = 0
    engine_id: int | None = None
    hit_tokens: int = 0

    @property
    def ttft(self) -> float | None:
        if self.t_first_token is None:
            return None
        return self.t_first_token - self.arrival

    @property
    def tpot(self) -> float | None:
        if self.t_done is None or self.t_first_token is None or self.tokens_out <= 1:
            return None
        return (self.t_done - self.t_first_token) / max(1, self.tokens_out - 1)


def percentile(xs: list[float], p: float) -> float:
    if not xs:
        return float("nan")
    xs = sorted(xs)
    i = min(len(xs) - 1, int(round(p / 100 * (len(xs) - 1))))
    return xs[i]


def summarize(reqs: list[Request], span: float) -> dict:
    done = [r for r in reqs if r.state == "done"]
    ttfts = [r.ttft for r in done if r.ttft is not None]
    tpots = [r.tpot for r in done if r.tpot is not None]
    return {
        "n_done": len(done),
        "avg_ttft_s": sum(ttfts) / max(1, len(ttfts)),
        "p99_ttft_s": percentile(ttfts, 99),
        "avg_tpot_s": sum(tpots) / max(1, len(tpots)),
        "p99_tpot_s": percentile(tpots, 99),
        "qps": len(done) / max(span, 1e-9),
        "hit_tokens": sum(r.hit_tokens for r in done),
        "total_prompt_tokens": sum(len(r.tokens) for r in done),
    }
