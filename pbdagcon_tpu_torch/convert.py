"""State that crosses from the JAX package to the port.

This system has no weights. What crosses is the run configuration and
the packed DP batch, so that both packages can be fed identical inputs.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pbdagcon_tpu_torch.config import DagconConfig

# The JAX package's TPU forms of the DP all become the CUDA kernel.
_BACKENDS = {"xla": "cuda", "blocked": "cuda", "pallas": "cuda"}


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
