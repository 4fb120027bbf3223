"""The twelve ``repro_torch.configs.<arch>`` selectors against
``repro.configs.<arch>``: ``CONFIG`` and ``SMOKE_CONFIG`` equal field by
field, ``CONFIG`` the registry's entry for its arch."""

from __future__ import annotations

import dataclasses
import importlib
import pathlib

import pytest

from repro_torch.configs.registry import get_config

SELECTORS = ["arctic_480b", "command_r_35b", "internlm2_1_8b", "internvl2_26b",
             "jamba_1_5_large_398b", "llama31_8b", "llama4_maverick_400b_a17b", "mamba2_2_7b",
             "musicgen_large", "olmo_1b", "qwen1_5_0_5b", "qwen3_32b"]


def test_every_reference_selector_has_a_twin():
    src = pathlib.Path(__file__).resolve().parents[1] / "src"
    for pkg in ("repro", "repro_torch"):
        found = sorted(p.stem for p in (src / pkg / "configs").glob("*.py")
                       if p.stem not in ("__init__", "base", "registry"))
        assert found == SELECTORS, pkg


@pytest.mark.parametrize("name", SELECTORS)
def test_selector_equals_the_reference(name):
    port = importlib.import_module(f"repro_torch.configs.{name}")
    ref = importlib.import_module(f"repro.configs.{name}")
    for attr in ("CONFIG", "SMOKE_CONFIG"):
        got, want = getattr(port, attr), getattr(ref, attr)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), attr
    assert port.CONFIG is get_config(port.CONFIG.name)
    assert port.SMOKE_CONFIG.name == f"{port.CONFIG.name}-smoke"
