"""The exp12 twin (``repro_torch/experiments/exp12_control_plane.py``)
against ``benchmarks/exp12_control_plane.py``:

* ``--fast`` through ``main``: the reference's row names (less
  ``exp12.exp05_wall``, omitted by design) with its ``derived`` keys (less
  the match row's PR-1 reference, which the reference prints only at full
  size), every deterministic check held, the JSON written only to
  ``--json``'s path and no ``BENCH_control_plane*.json`` anywhere;
* ``engine_loop``'s events equal to the reference's at both sizes, and to
  ``PINNED_EVENTS``;
* ``check_failures`` names each broken check.

The timings are host wall time of this machine and are not compared.
"""

from __future__ import annotations

import copy
import json
import os

import pytest

import benchmarks.exp12_control_plane as jexp12
from repro_torch.experiments import exp12_control_plane as exp12


def _keys(derived: str) -> list[str]:
    return [kv.split("=")[0] for kv in derived.split(";")]


@pytest.fixture(scope="module")
def fast_run(tmp_path_factory):
    """One --fast run through ``main`` in an empty directory, and the
    reference's rows at the same size (its run writes its JSON into the
    working directory, so it runs in another empty one)."""
    here = os.getcwd()
    port_dir, jax_dir = tmp_path_factory.mktemp("port"), tmp_path_factory.mktemp("jax")
    try:
        os.chdir(port_dir)
        rows = exp12.main(["--fast", "--json", "out.json"])
        made = sorted(os.listdir(port_dir))
        os.chdir(jax_dir)
        jrows = jexp12.run(fast=True)
    finally:
        os.chdir(here)
    return rows, json.loads((port_dir / "out.json").read_text()), made, jrows


def test_fast_rows_carry_the_reference_s_names_and_keys(fast_run):
    rows, results, made, jrows = fast_run
    jnames = [r[0] for r in jrows if r[0] != "exp12.exp05_wall"]
    assert [r[0] for r in rows] == jnames
    assert [_keys(r[2]) for r in rows] == [_keys(r[2]) for r in jrows[: len(rows)]]
    assert all(float(r[1]) > 0 for r in rows)
    assert made == ["out.json"]  # no BENCH_control_plane*.json, only --json's path


def test_fast_checks_hold(fast_run):
    _, results, _, _ = fast_run
    assert results["fast"] is True and results["failures"] == []
    assert results["alloc_release"]["same_ids"] is True
    mp = results["match_prefix"]
    assert (mp["n_tokens"], mp["n_keys"], mp["seed_matched"], mp["new_matched"]) == (
        4096, 256, 0, 256)
    sr = results["scatter_read"]
    assert sr["same_bytes"] is True and sr["n_blocks_read"] == 64
    assert sr["block_bytes"] == exp12.scatter_layout(False).block_bytes == 65536
    assert results["engine_loop"]["events"] == exp12.PINNED_EVENTS["fast"]


@pytest.mark.parametrize("size,kw", [("fast", dict(n=64, in_len=2048)),
                                     ("full", dict(n=256, in_len=4096))])
def test_engine_loop_events_equal_the_reference(size, kw):
    got = exp12.bench_engine_loop(**kw)
    want = jexp12.bench_engine_loop(**kw)
    assert got["events"] == want["events"] == exp12.PINNED_EVENTS[size]
    assert (got["n_clients"], got["n_engines"], got["in_len"]) == (
        want["n_clients"], want["n_engines"], want["in_len"])


def test_full_scatter_layout_is_the_reference_s():
    lay = exp12.scatter_layout(True)
    assert (lay.n_fragments, lay.block_bytes) == (128, 4 << 20)


@pytest.mark.parametrize("broken", ["ids", "seed_match", "new_match", "bytes", "events"])
def test_check_failures_names_each_broken_check(fast_run, broken):
    _, results, _, _ = fast_run
    bad = copy.deepcopy(results)
    if broken == "ids":
        bad["alloc_release"]["same_ids"] = False
    elif broken == "seed_match":
        bad["match_prefix"]["seed_matched"] = 1
    elif broken == "new_match":
        bad["match_prefix"]["new_matched"] -= 1
    elif broken == "bytes":
        bad["scatter_read"]["same_bytes"] = False
    else:
        bad["engine_loop"]["events"] += 1
    got = exp12.check_failures(bad)
    assert len(got) == 1, got
    full = copy.deepcopy(results)
    full["fast"] = False  # a full-size run is held to the full pin
    assert exp12.check_failures(full) == [
        f"engine_loop: {exp12.PINNED_EVENTS['fast']} events, pinned "
        f"{exp12.PINNED_EVENTS['full']}"]


def _full_results() -> dict:
    """A full-size run's results as phase 22 reads them (timings left out)."""
    return {
        "fast": False,
        "alloc_release": {"pool_blocks": 65536, "n_shards": 32, "group": 16, "same_ids": True},
        "match_prefix": {"n_tokens": 15000, "n_keys": 937, "seed_matched": 0,
                         "new_matched": 937},
        "scatter_read": {"n_blocks_read": 64, "same_bytes": True,
                         "block_bytes": exp12.scatter_layout(True).block_bytes},
        "engine_loop": {"n_clients": 256, "in_len": 4096,
                        "events": exp12.PINNED_EVENTS["full"]},
    }


@pytest.mark.parametrize("events", [None, -1, 1, "fast"])
def test_chip_smoke_phase_22_check_refuses_a_wrong_event_count(events, capsys):
    import chip_smoke

    res = _full_results()
    if events is None:
        chip_smoke.exp12_check(res)  # every check holds
        assert capsys.readouterr().out.count("  ok: ") == 6
        return
    want = exp12.PINNED_EVENTS["full"]
    res["engine_loop"]["events"] = exp12.PINNED_EVENTS["fast"] if events == "fast" else (
        want + events)
    with pytest.raises(SystemExit, match="engine_loop.*PINNED_EVENTS"):
        chip_smoke.exp12_check(res)


@pytest.mark.parametrize("part,key,value", [
    ("alloc_release", "same_ids", False), ("match_prefix", "seed_matched", 3),
    ("scatter_read", "same_bytes", False), ("scatter_read", "block_bytes", 65536)])
def test_chip_smoke_phase_22_check_refuses_each_broken_check(part, key, value):
    import chip_smoke

    res = _full_results()
    res[part][key] = value
    with pytest.raises(SystemExit, match=f"exp12 {part}"):
        chip_smoke.exp12_check(res)
    with pytest.raises(SystemExit, match="full size"):
        chip_smoke.exp12_check({**_full_results(), "fast": True})
