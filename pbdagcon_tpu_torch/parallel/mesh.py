"""Device mesh, sharded consensus DP and collective metrics (port of
`pbdagcon_tpu/parallel/mesh.py`).

Targets are embarrassingly parallel, so the mesh is one axis
("targets") of slots, each slot a device of this process, and the DP
batch dimension is split over the slots: each slot's shard runs kernel
B1 on its device with no communication. A slot may repeat a device
(two shards on one card). The mesh is the process's own devices, as the
reference's `jax.devices()` is in one process; a run over several
processes (`--distributed`) shards targets over the ranks instead, and
`metrics_allreduce` then also sums the counters over the process group.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from pbdagcon_tpu_torch.ops.dp import DP_ARGS, dp_scores


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: a tuple of devices (a device may repeat), axis
    'targets'."""

    devices: tuple
    axis: str = "targets"

    def __post_init__(self) -> None:
        devs = tuple(torch.device(d) for d in self.devices)
        if not devs:
            raise ValueError("a mesh needs at least one slot")
        object.__setattr__(self, "devices", devs)

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(n_devices: int | None = None, device="cuda") -> Mesh:
    """1-D mesh over this process's devices of `device`'s type: for a
    bare "cuda" the first `n_devices` cards (default every visible card;
    raises where there is none, or fewer than asked), for a card with an
    index ("cuda:1", a run's `--device` or a rank's card) one slot on
    that card, for "cpu" `n_devices` slots of the CPU (default 1).
    `device` is a string or a torch.device."""
    dev = torch.device(device)
    kind = dev.type
    if kind == "cuda":
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if count == 0:
            raise RuntimeError(
                "make_mesh: no CUDA card is visible (pass device='cpu' for "
                "a mesh of CPU slots)"
            )
        if dev.index is not None:
            if n_devices not in (None, 1):
                raise ValueError(f"make_mesh: {n_devices} slots asked of the "
                                 f"one card {dev}")
            if dev.index >= count:
                raise ValueError(f"make_mesh: {dev} asked, {count} visible")
            return Mesh((dev,))
        n = count if n_devices is None else n_devices
        if not 1 <= n <= count:
            raise ValueError(f"make_mesh: {n} cards asked, {count} visible")
        return Mesh(tuple(torch.device("cuda", i) for i in range(n)))
    if kind == "cpu":
        n = 1 if n_devices is None else n_devices
        if n < 1:
            raise ValueError(f"make_mesh: {n} slots asked")
        return Mesh((torch.device("cpu"),) * n)
    raise ValueError(f"make_mesh: no mesh of {kind} devices")


def _pad_batch_to(arrs: dict, mult: int) -> tuple[dict, int]:
    """Pad the batch dim to a multiple of the mesh size (dummy targets
    have no edges; their scores are ignored)."""
    B = arrs["win_count"].shape[0]
    rem = (-B) % mult
    if rem == 0:
        return arrs, B
    out = {}
    for k, v in arrs.items():
        if k == "n":
            out[k] = np.concatenate([v, np.zeros(rem, v.dtype)])
            continue
        pad = np.zeros((rem,) + v.shape[1:], dtype=v.dtype)
        if k in ("win_count", "exit_count", "long_u", "long_w"):
            pad[:] = -1
        if k == "long_esc":
            pad[:] = np.float32(-np.inf)
        out[k] = np.concatenate([v, pad], axis=0)
    return out, B


def dp_scores_sharded(batch: dict, mesh: Mesh) -> np.ndarray:
    """The batched DP with the batch dimension split over `mesh`.

    `batch` is `ops.dp.pad_batch` output (numpy). The batch is padded to
    a multiple of the mesh size and cut into contiguous shards, slot d
    taking shard d; every shard is uploaded and its DP enqueued on its
    slot's device (kernel B1 on a card, the plain version on the CPU)
    before any is fetched. Returns scores [B, V] f32 (unpadded), the
    shards in slot order."""
    padded, B = _pad_batch_to(batch, mesh.size)
    per = padded["win_count"].shape[0] // mesh.size
    outs = []
    for d, dev in enumerate(mesh.devices):
        args = []
        for k in DP_ARGS:
            t = torch.from_numpy(
                np.ascontiguousarray(padded[k][d * per:(d + 1) * per]))
            if dev.type == "cuda":
                t = t.pin_memory().to(dev, non_blocking=True)
            args.append(t)
        outs.append(dp_scores(*args))
    return torch.cat([o.cpu() for o in outs]).numpy()[:B]


def metrics_allreduce(per_host_counters: np.ndarray, mesh: Mesh) -> np.ndarray:
    """Global sum of integer or float counters over the mesh's slots and,
    where a `torch.distributed` group is initialised, over its ranks.

    A 1-D row is this process's counters: slot 0 carries it, the others
    zero. A 2-D array has one row per slot. The slots' rows are summed,
    then the sum is all-reduced over the process group (a CPU int64 or
    float64 tensor, gloo), as the reference's `psum` spans every process
    of a mesh under `jax.distributed`."""
    c = np.asarray(per_host_counters)
    if c.ndim == 1:
        rows = np.zeros((mesh.size, c.shape[0]), dtype=c.dtype)
        rows[0] = c
    else:
        rows = c
    if rows.ndim != 2 or rows.shape[0] != mesh.size:
        raise ValueError(f"counters of shape {c.shape} do not give one row "
                         f"to each of {mesh.size} slots")
    wide = np.float64 if np.issubdtype(rows.dtype, np.floating) else np.int64
    total = torch.from_numpy(rows.astype(wide).sum(axis=0))
    if dist.is_available() and dist.is_initialized():
        dist.all_reduce(total, op=dist.ReduceOp.SUM)
    return total.numpy()
