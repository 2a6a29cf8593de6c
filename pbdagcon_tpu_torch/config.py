"""Run configuration of the PyTorch/CUDA port, mirroring the reference
`dagcon` CLI semantics.

Same reference knobs and defaults as `pbdagcon_tpu.config.DagconConfig`
(`-c` min coverage 8, `-m` min length 500, `-j` threads 4, `-t` trim 0).
The execution knobs differ: the port's backends are "cuda" (the banded
DP runs in the hand-written kernel, `ops/dp_cuda.py`), "blocked" (as
"cuda", with the batches the int32 bound admits in the blocked max-plus
solve, `ops/dp_blocked.py`, and its flagged rows in the scan), "devbuild" (graph
build, DP and backtrack on the device, `devpipe.py`), "hybrid" (the host
engine and the devbuild pipeline on group-aligned chunks side by side,
`hybrid.py`) and "host" (the native engine runs everything). "auto"
runs "hybrid" on a card with the native engine present, as the
reference does on an accelerator, unless DAGCON_AUTO_HYBRID=0; otherwise
(no engine, or device "cpu") it runs "cuda" (`pipeline.auto_takes_hybrid`).
`device` picks where the device work runs: a CUDA device launches the
kernels, and an explicit "cpu" runs their plain PyTorch versions (tests).
"""

from __future__ import annotations

import dataclasses
import os


def resolve_device(device):
    """`device` as a torch.device. A CUDA device that is absent raises:
    the port never carries on on the CPU unless asked to."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but CUDA is not available "
            "(pass device='cpu' to run the kernels' plain PyTorch versions)"
        )
    return dev


# Backends of the JAX package that the port does not run (yet), with
# the ROADMAP item that ports each.
_NOT_PORTED = {
    "xla": "the TPU forms of the DP are one kernel here: use "
    "backend='cuda' (ROADMAP B1)",
    "pallas": "the TPU forms of the DP are one kernel here: use "
    "backend='cuda' (ROADMAP B1)",
}


@dataclasses.dataclass(frozen=True)
class DagconConfig:
    # Reference-equivalent knobs (dagcon -c / -m / -j / -t).
    min_weight: int = 8
    min_length: int = 500
    threads: int = 4
    trim: int = 0

    # Input format: "m5" (blasr -m 5) or "pre" (HGAP m4topre records).
    fmt: str = "m5"
    # Re-align raw (ungapped) q/t pairs before graph building (dagcon -a).
    align: bool = False
    # Where -a alignment runs: "host" (threaded C++ banded DP) or
    # "device" (kernel X1, `ops/align_tpu.py`; the "cuda" and "blocked"
    # backends on raw 'pre' records only, as in the reference). Both are
    # exact.
    align_backend: str = "host"
    # -a scorer: "simple" (SPEC §1.5) or "affine" (SPEC §1.6).
    align_scorer: str = "simple"
    affine_params: tuple[int, int, int, int] = (1, -2, -4, -1)

    # Bucket ladders for padded shapes (nodes V, band width W).
    v_buckets: tuple[int, ...] = (256, 512, 1024, 2048, 4096, 8192, 16384)
    w_buckets: tuple[int, ...] = (16, 32, 64, 128)
    # Targets per device dispatch.
    batch_targets: int = 128
    # "cuda" (device DP kernel), "blocked" (the blocked max-plus solve
    # where the int32 bound admits a batch, else the DP kernel),
    # "devbuild" (all on the device), "hybrid" (host engine + devbuild
    # side by side), "host" (all native) or "auto" (hybrid on a card
    # with the native engine, unless DAGCON_AUTO_HYBRID=0; else cuda).
    backend: str = "auto"
    # Device of the "cuda" and "devbuild" backends: a CUDA device, or
    # "cpu" for the kernels' plain PyTorch versions.
    device: str = "cuda"
    # Use the native C++ loader/graph engine when available.
    use_native: bool = True
    # Feed-chunk size for the streaming loader, in MB (DAGCON_CHUNK_MB
    # env overrides): the most text one native engine call is fed.
    chunk_mb: int = 16

    def __post_init__(self) -> None:
        if self.fmt not in ("m5", "pre"):
            raise ValueError(f"fmt must be 'm5' or 'pre', got {self.fmt!r}")
        if self.align_backend not in ("host", "device"):
            raise ValueError(f"unknown align_backend {self.align_backend!r}")
        if self.align_scorer not in ("simple", "affine"):
            raise ValueError(f"unknown align_scorer {self.align_scorer!r}")
        if self.align_scorer == "affine":
            m, x, o, e = self.affine_params
            if not (m >= 0 and x <= 0 and o <= e <= 0):
                raise ValueError(
                    "affine_params must satisfy match>=0, mismatch<=0, "
                    f"open<=extend<=0; got {self.affine_params}"
                )
            if self.align_backend == "device":
                raise ValueError(
                    "align_backend='device' implements the simple scorer "
                    "only; use align_backend='host' with align_scorer="
                    "'affine'"
                )
        if self.backend in _NOT_PORTED:
            raise NotImplementedError(
                f"backend {self.backend!r} is not ported: "
                f"{_NOT_PORTED[self.backend]}"
            )
        if self.backend not in (
            "auto", "cuda", "blocked", "devbuild", "hybrid", "host"
        ):
            raise ValueError(f"unknown backend {self.backend!r}")
        if self.min_weight < 0 or self.min_length < 0 or self.trim < 0:
            raise ValueError("min_weight/min_length/trim must be >= 0")
        if self.batch_targets < 1 or self.chunk_mb < 1:
            raise ValueError("batch_targets and chunk_mb must be >= 1")

    def chunk_bytes(self) -> int:
        """The feed-chunk size in bytes: DAGCON_CHUNK_MB, else chunk_mb."""
        return int(os.environ.get("DAGCON_CHUNK_MB", str(self.chunk_mb))) << 20
