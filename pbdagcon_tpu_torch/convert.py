"""State that crosses from the JAX package to the port.

This system has no weights. What crosses is the run configuration, the
packed DP batch and the device build's arrays, so that both packages can
be fed identical inputs.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pbdagcon_tpu_torch.config import DagconConfig

# The JAX package's scan forms of the DP become the CUDA kernel; its
# blocked solve is the port's too.
_BACKENDS = {"xla": "cuda", "pallas": "cuda"}


def config_from_jax(cfg, device: str = "cuda") -> DagconConfig:
    """Port `DagconConfig` from a `pbdagcon_tpu.config.DagconConfig`.
    Backends and options the port does not run raise, as in
    `DagconConfig.__post_init__`."""
    shared = {
        f.name: getattr(cfg, f.name)
        for f in dataclasses.fields(DagconConfig)
        if f.name not in ("backend", "device")
    }
    return DagconConfig(
        backend=_BACKENDS.get(cfg.backend, cfg.backend),
        device=device,
        **shared,
    )


def tree_to_torch(tree, device):
    """A nested dict of numpy arrays (the JAX `device_build` output
    after `np.asarray` on each leaf, or its stage outputs) as the same
    dict of tensors on `device`, dtypes kept, so that the port's DP and
    emit stages can be fed the JAX build's exact arrays."""
    if isinstance(tree, dict):
        return {k: tree_to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_to_torch(v, device) for v in tree)
    return torch.from_numpy(np.array(tree, copy=True, order="C")).to(device)


def batch_to_torch(
    batch: dict[str, np.ndarray], device
) -> dict[str, torch.Tensor]:
    """Tensors on `device` from a packed batch (`pad_batch` or a native
    `pack_batch`, of either package), dtypes kept. Keys starting with
    '_' (arena, dims) are host-side bookkeeping and are dropped."""
    return {
        k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
        for k, v in batch.items()
        if not k.startswith("_")
    }
