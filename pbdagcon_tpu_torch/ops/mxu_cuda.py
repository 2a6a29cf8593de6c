"""Wrappers of the hand-written Hopper histogram and scatter kernels
(`csrc/hist_scatter.cu`), and their launch plans.

`hist_cuda` replaces the TPU kernel `pbdagcon_tpu/ops/mxu.py::_pallas_hist`
and `scatter_cuda` replaces `pbdagcon_tpu/ops/mxu.py::_pallas_scatter`;
the contracts are those of `ops/mxu.py` (the plain PyTorch versions sit
there too, with the same arguments). Neither wrapper falls back to the
plain version: each checks what it is given, raises on anything the
kernel does not take, and raises if the build, the plan or the launch
fails. Every route writes each output element, so the outputs are
`torch.empty` (the global route, which no devbuild call reaches, zeroes
them itself). Both launch on the current stream without synchronising.

`hist_plan` / `scatter_plan` choose each call's launch plan (`BinPlan`),
which the kernel file checks and mirrors by constants:

- "cluster": a row's bins in the shared memory of `cluster` CTAs (1: one
  CTA, no cluster), CTA r owning bins [r * bins, (r + 1) * bins) of
  every plane and reading a 1/cluster slice of the row's values. The
  fewest CTAs that hold the planes: more only to fill the card at small
  B measured slower on real devbuild windows (`tools/bins_ablate.py`),
  so B does not change the plan.
- "global": planes past what a MAX_CLUSTER-CTA cluster holds; zeroed
  outputs and global atomics.

`cluster_plan` makes a cluster-route plan of a given size (the tests and
`tools/bins_ablate.py` force other plans with it).

`launches` counts each kernel's launches by name ("hist", "scatter").
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from pbdagcon_tpu_torch.ops import _build

launches = {"hist": 0, "scatter": 0}
MAX_PAYLOADS = 4  # kMaxPayloads
# The shared memory a CTA may use on an H100 (kMaxSmemBytes).
MAX_SMEM = 232448
# The most CTAs to a cluster, with the non-portable attribute past 8
# (kMaxCluster).
MAX_CLUSTER = 16
ROUTES = ("cluster", "global")


@dataclasses.dataclass(frozen=True)
class BinPlan:
    """One call's launch plan: route, CTAs per row (`cluster`), bins per
    plane each CTA owns, threads per CTA and dynamic shared bytes. Every
    route is one kernel launch."""

    route: str
    cluster: int
    bins: int
    threads: int
    smem: int

    def args(self) -> tuple[int, ...]:
        """The plan as `dagcon_hist` / `dagcon_scatter` take it."""
        return (ROUTES.index(self.route), self.cluster, self.bins,
                self.threads, self.smem)

    def owners(self, D: int) -> list[tuple[int, int]]:
        """[lo, hi) of the bins each CTA of a row writes (cluster
        route), or the whole row's (the global route's outputs)."""
        if self.route != "cluster":
            return [(0, D)]
        return [(r * self.bins, min(D, (r + 1) * self.bins))
                for r in range(self.cluster)]

    def value_slices(self, N: int) -> list[tuple[int, int]]:
        """[lo, hi) of the values each CTA of a row reads (cluster
        route: `per` = ceil(N / cluster) rounded up to 4, as the kernel
        computes it)."""
        if self.route != "cluster":
            return [(0, N)]
        per = _round4(-(-N // self.cluster))
        return [(min(N, r * per), min(N, (r + 1) * per))
                for r in range(self.cluster)]

    def describe(self) -> str:
        if self.route == "cluster":
            return (f"cluster cs={self.cluster} bins={self.bins} "
                    f"threads={self.threads} smem={self.smem}")
        return f"global threads={self.threads}"


def _round4(x: int) -> int:
    return -(-x // 4) * 4


def fewest_ctas(D: int, NP: int) -> int:
    """The fewest CTAs whose shared memory holds NP planes of D bins."""
    plane_bins = MAX_SMEM // (4 * NP) // 4 * 4
    return -(-_round4(max(D, 1)) // plane_bins)


def cluster_plan(N: int, D: int, NP: int, cs: int,
                 threads: int | None = None) -> BinPlan:
    """A cluster-route plan of at most `cs` CTAs per row (as many as
    leave none without bins) for rows of N values into NP planes of D
    bins. `threads` defaults to the least power of two from 128 to 1024
    that covers a pass over the CTA's values (8 per thread) and the
    clearing of its bins (4 per thread)."""
    bins = _round4(-(-max(D, 1) // cs))
    cs = -(-max(D, 1) // bins)
    if threads is None:
        per = -(-N // cs)
        work = max(-(-per // 8), NP * bins // 4)
        threads = 128
        while threads < 1024 and threads < work:
            threads *= 2
    return BinPlan("cluster", cs, bins, threads, NP * bins * 4)


def bin_plan(B: int, N: int, D: int, NP: int) -> BinPlan:
    """The launch plan of a call: B rows of N values or ranks into D
    bins of NP payload planes (a histogram is one plane). The fewest CTAs
    per row that hold the planes, whatever B."""
    if not 1 <= NP <= MAX_PAYLOADS:
        raise ValueError(f"kernel takes 1..{MAX_PAYLOADS} planes, got {NP}")
    cs = fewest_ctas(D, NP)
    if cs > MAX_CLUSTER:
        return BinPlan("global", 1, 0, 512, 0)
    return cluster_plan(N, D, NP, cs)


def hist_plan(B: int, N: int, D: int) -> BinPlan:
    """`hist_cuda`'s plan for [B, N] values into D bins."""
    return bin_plan(B, N, D, 1)


def scatter_plan(B: int, N: int, D: int, NP: int) -> BinPlan:
    """`scatter_cuda`'s plan for [B, N] ranks and NP payloads into D
    bins."""
    return bin_plan(B, N, D, NP)


def _check_rows(t: torch.Tensor, name: str, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.int32:
        raise TypeError(f"{name} has dtype {t.dtype}, expected torch.int32")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _dims(values: torch.Tensor, D: int) -> tuple[int, int]:
    if values.device.type != "cuda":
        raise ValueError(f"the kernel needs CUDA tensors, got {values.device}")
    if values.dim() != 2:
        raise ValueError(f"expected [B, N], got {tuple(values.shape)}")
    B, N = values.shape
    if B > 65535 or N >= 1 << 31 or not 0 <= D < 1 << 31:
        raise ValueError(f"kernel takes B <= 65535, N, D < 2^31; got "
                         f"B={B}, N={N}, D={D}")
    return B, N


def _valid_bytes(valid, B: int, N: int, device) -> torch.Tensor | None:
    """The valid mask as contiguous [B, N] bytes (broadcast first), or
    None."""
    if valid is None:
        return None
    if valid.device != device:
        raise ValueError(f"valid is on {valid.device}, expected {device}")
    if valid.dtype != torch.bool:
        raise TypeError(f"valid has dtype {valid.dtype}, expected torch.bool")
    return torch.broadcast_to(valid, (B, N)).contiguous().view(torch.uint8)


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def hist_cuda(values: torch.Tensor, valid, D: int, *,
              plan: BinPlan | None = None) -> torch.Tensor:
    """[B, D] int32 counts of each row's valid values in [0, D) (others
    dropped) by the CUDA kernel. values: [B, N] int32, contiguous; valid:
    a bool mask broadcastable to [B, N], or None (every value counts).
    `plan` overrides `hist_plan` (the kernel refuses a plan it does not
    take)."""
    B, N = _dims(values, D)
    _check_rows(values, "values", (B, N), values.device)
    vb = _valid_bytes(valid, B, N, values.device)
    plan = plan or hist_plan(B, N, D)
    lib = _build.load("hist_scatter")
    out = torch.empty((B, D), dtype=torch.int32, device=values.device)
    if out.numel():
        with torch.cuda.device(values.device):
            rc = lib.dagcon_hist(
                values.data_ptr(), None if vb is None else vb.data_ptr(),
                out.data_ptr(), B, N, D, *plan.args(), _stream(values.device),
            )
        _build.check(lib, rc, f"hist launch ({plan.describe()})")
        launches["hist"] += 1
    return out


def _check_scatter(ranks, payloads, D: int, cut_mask: int) -> tuple[int, int]:
    """(B, N) of a scatter's arguments; raises on what the kernels do not
    take."""
    B, N = _dims(ranks, D)
    if not 1 <= len(payloads) <= MAX_PAYLOADS:
        raise ValueError(f"kernel takes 1..{MAX_PAYLOADS} payloads, got "
                         f"{len(payloads)}")
    if not 0 < cut_mask <= 0xFFFFFFFF:
        raise ValueError(f"cut_mask must be a nonzero 32-bit mask, got {cut_mask}")
    _check_rows(ranks, "ranks", (B, N), ranks.device)
    for k, p in enumerate(payloads):
        _check_rows(p, f"payloads[{k}]", (B, N), ranks.device)
    return B, N


def scatter_cuda(
    ranks: torch.Tensor, valid, payloads: tuple[torch.Tensor, ...], D: int,
    cut_mask: int, *, plan: BinPlan | None = None,
) -> tuple[torch.Tensor, ...]:
    """out[k][b, ranks[b, n]] += payloads[k][b, n] & cut_mask over valid
    n, int32 with wraparound, by the CUDA kernel; ranks outside [0, D)
    dropped. ranks and each payload: [B, N] int32, contiguous; valid as
    for `hist_cuda`. Returns one [B, D] int32 tensor per payload. `plan`
    overrides `scatter_plan`."""
    B, N = _check_scatter(ranks, payloads, D, cut_mask)
    vb = _valid_bytes(valid, B, N, ranks.device)
    NP = len(payloads)
    plan = plan or scatter_plan(B, N, D, NP)
    lib = _build.load("hist_scatter")
    outs = tuple(
        torch.empty((B, D), dtype=torch.int32, device=ranks.device)
        for _ in payloads
    )
    if outs[0].numel():
        p_arr = (ctypes.c_void_p * NP)(*(p.data_ptr() for p in payloads))
        o_arr = (ctypes.c_void_p * NP)(*(o.data_ptr() for o in outs))
        with torch.cuda.device(ranks.device):
            rc = lib.dagcon_scatter(
                ranks.data_ptr(), None if vb is None else vb.data_ptr(),
                p_arr, o_arr, NP, B, N, D, cut_mask, *plan.args(),
                _stream(ranks.device),
            )
        _build.check(lib, rc, f"scatter launch ({plan.describe()})")
        launches["scatter"] += 1
    return outs
