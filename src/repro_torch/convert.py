"""Carry a JAX parameter tree into the port, bit for bit.

``params_from_numpy`` takes the tree of a JAX ``Model.init`` with every leaf
already turned into a numpy array (``jax.tree.map(np.asarray, params)``)
and returns the port's tree of tensors. bfloat16 and float8_e4m3fn (an fp8
KV cache) arrive as ``ml_dtypes`` types, which torch cannot read directly;
their bits move as uint16 or uint8 and are viewed as ``torch.bfloat16`` or
``torch.float8_e4m3fn`` again, so no value is rounded.

Under a mesh (``rules``) it takes JAX's tree in the tp-padded layout of
``rules.tp`` (a JAX ``Model`` with those rules draws it) and returns this
rank's shards of it: each leaf is cut on the host before it moves. This is
how JAX's weights reach a world of ranks.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import local_shape, local_slice
from repro_torch.models.model import param_specs


# ml_dtypes' name -> (the integer type its bits move as, the torch dtype)
_VIEWED = {"bfloat16": (np.uint16, torch.bfloat16),
           "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn)}


def tensor_from_numpy(arr: np.ndarray, device) -> torch.Tensor:
    arr = np.array(arr)  # an owned, writable, contiguous copy
    if arr.dtype.name in _VIEWED:
        bits, dtype = _VIEWED[arr.dtype.name]
        return torch.from_numpy(arr.view(bits)).view(dtype).to(device)
    return torch.from_numpy(arr).to(device)


def params_from_numpy(tree: dict, cfg: ModelConfig, device, rules=None,
                      tp: int | None = None) -> dict:
    """Checks names, shapes and each leaf's own dtype against
    ``param_specs(cfg, tp)`` (tp: the rules' TP degree, else ``tp`` or 1);
    under ``rules`` returns this rank's shards."""
    tp = rules.tp if rules is not None else (tp or 1)

    def walk(got: dict, spec: dict, path: str) -> dict:
        if set(got) != set(spec):
            raise ValueError(f"{path or 'params'}: keys {sorted(got)} != {sorted(spec)}")
        out = {}
        for k, s in spec.items():
            if isinstance(s, dict):
                out[k] = walk(got[k], s, f"{path}/{k}")
                continue
            arr = np.asarray(got[k])
            if rules is not None and tuple(arr.shape) == s.shape:
                arr = local_slice(arr, rules.spec(s.logical_axes), rules.mesh, f"{path}/{k}")
            t = tensor_from_numpy(arr, device)
            want = (s.shape if rules is None else
                    local_shape(s.shape, rules.spec(s.logical_axes), rules.mesh, f"{path}/{k}"))
            if tuple(t.shape) != want or t.dtype != s.dtype:
                raise ValueError(f"{path}/{k}: {tuple(np.shape(got[k]))} {t.dtype}, "
                                 f"want {s.shape} {s.dtype}")
            out[k] = t
        return out

    return walk(tree, param_specs(cfg, tp), "")
