"""Wrappers of the hand-written Hopper kernels of the kernel-variant
microbench (`csrc/pk_variants.cu`), and the launch plans of P2 and P3.

- `hist_v1_cuda` (`hist_wgmma_kernel`, s8 one-hot products on the tensor
  cores by `wgmma`, sm_90a only, under the launch plan `hist_v1_plan`)
  replaces the TPU kernel `tools/prof_pk.py::hist_v1`;
- `hist_v2_cuda` (`hist_row_kernel`, one CTA per row: the row staged into
  shared memory by TMA bulk copies beside its whole histogram, under
  `hist_row_plan`) replaces `tools/prof_pk.py::hist_v2`;
- `scatter_tile_cuda` (`scatter_tile_kernel`, one CTA per D tile of a
  row, each accumulating its tile in shared memory and staging the row's
  aligned middle by TMA bulk copies; under `tile_plan`) replaces
  `tools/prof_pk.py::pallas_scatter`.

The contracts are those of `ops/mxu.py::hist_reference` and
`scatter_reference`, the plain versions. No wrapper falls back to them:
each checks what it is given, raises on anything its kernel does not take,
and raises if the build or the launch fails. Every kernel writes each
element of its output, so the outputs are `torch.empty`. All launch on the
current stream without synchronising.

The plans mirror the kernel file's constants, which it checks. P2 and P3
stage rows by one piece plan (`row_pieces`): bulk copies take each row's
16-byte-aligned middle in chunks, and consumer threads read the < 4
values before and after it with plain loads.

`launches` counts each kernel's launches under the JAX tool's names.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from pbdagcon_tpu_torch.ops import _build
from pbdagcon_tpu_torch.ops.mxu_cuda import (
    MAX_PAYLOADS,
    _check_rows,
    _check_scatter,
    _dims,
)

launches = {"hist_v1": 0, "hist_v2": 0, "pallas_scatter": 0}
# hist_row_kernel's shared-memory histogram (`kMaxRowBins`).
MAX_ROW_BINS = 48 * 1024
# The kernels' bound on N and D (`kMaxExtent`).
MAX_EXTENT = 1 << 30
# The shared memory a CTA may use (`kMaxSmemBytes`).
MAX_SMEM = 232448
# P3: chunks of TILE_CHUNK values (256 quads, one per thread of a group of
# consumers), 2 to 8 ring stages; tiles sized beside TILE_STAGES of them.
TILE_CHUNK = 1024
MIN_STAGES, MAX_STAGES = 2, 8
TILE_STAGES = 4
# P2: pieces of ROW_CHUNK values (one quad per each of 992 consumers).
ROW_CHUNK = 3968
_MBAR = 8  # bytes of an mbarrier
# The N widths PTX allows for an s8 wgmma (m64nNk32), the most hi rows a
# hist_wgmma block holds (`kMaxHiTile`: the widest of them below 255, so
# that the sentinel byte is never a row; ptxas keeps its 120 accumulator
# registers a thread without spills), and the sentinel: the hi byte of a
# value that counts in no row of the block.
WGMMA_S8_WIDTHS = (8, 16, 24, *range(32, 257, 16))
HIST_V1_MAX_WIDTH = 240
HIST_V1_SENTINEL = 0xFF
def hist_v1_plan(D: int) -> tuple[int, int, int]:
    """P1's launch plan for D bins: (width, tiles, sentinel). The
    ceil(D / 128) hi rows go to the fewest tiles of at most
    HIST_V1_MAX_WIDTH rows, evened out, each `width` rows wide: the
    smallest s8 wgmma width that holds ceil(rows / tiles). Tile k covers
    hi rows [k * width, (k + 1) * width); none is empty."""
    rows = max(1, -(-D // 128))
    tiles = -(-rows // HIST_V1_MAX_WIDTH)
    need = -(-rows // tiles)
    width = next(w for w in WGMMA_S8_WIDTHS if w >= need)
    return width, tiles, HIST_V1_SENTINEL


def _round4(x: int) -> int:
    return -(-x // 4) * 4


def row_pieces(offset: int, N: int) -> tuple[int, int]:
    """The piece plan of a row of N int32 values whose value 0 lies
    `offset` values past a 16-byte boundary (mod 4 counts): (head, nb).
    The bulk copies take the middle [head, head + nb), whose start is
    16-byte aligned and whose size is a multiple of 16 bytes, in chunks
    that land at the start of their slots; the head [0, head) and the
    tail [head + nb, N) (fewer than 4 values each) are read with plain
    loads. As `row_pieces` in the kernel file."""
    head = min((4 - offset % 4) % 4, N)
    return head, (N - head) & ~3


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """P3's launch plan: `tiles` tiles of `bins` bins per row, a CTA
    each, `stages` ring stages, `smem` dynamic shared bytes."""

    tiles: int
    bins: int
    stages: int
    smem: int

    def args(self) -> tuple[int, ...]:
        """The plan as `dagcon_scatter_tile` takes it."""
        return (self.tiles, self.bins, self.stages, self.smem)

    def owners(self, D: int) -> list[tuple[int, int]]:
        """[lo, hi) of the bins each tile of a row writes."""
        return [(min(D, t * self.bins), min(D, (t + 1) * self.bins))
                for t in range(self.tiles)]

    def describe(self) -> str:
        return (f"tiles={self.tiles} bins={self.bins} stages={self.stages} "
                f"smem={self.smem}")


def tile_smem(NP: int, bins: int, stages: int) -> int:
    """P3's dynamic shared bytes: the ring (ranks and NP payloads per
    stage), NP planes of bins + 4 accumulators, two mbarriers a stage."""
    return (stages * (1 + NP) * TILE_CHUNK * 4 + NP * (bins + 4) * 4
            + 2 * stages * _MBAR)


def tile_bins_cap(NP: int) -> int:
    """The most bins per tile (a multiple of 4) that fit beside a ring of
    TILE_STAGES stages within MAX_SMEM."""
    free = MAX_SMEM - tile_smem(NP, 0, TILE_STAGES)
    return (free // (4 * NP) - 4) // 4 * 4


def tile_plan(N: int, D: int, NP: int) -> TilePlan:
    """P3's plan for rows of N ranks and NP payloads into D bins: the
    fewest tiles whose accumulators fit one CTA beside a ring of
    TILE_STAGES, evened out (bins a multiple of 4); then as many ring
    stages as the chunks use and the rest of MAX_SMEM holds. Narrower
    tiles, two CTAs to an SM, measured slower on the card (PERF.md,
    `tools/pk_ablate.py`)."""
    if not 1 <= NP <= MAX_PAYLOADS:
        raise ValueError(f"kernel takes 1..{MAX_PAYLOADS} payloads, got {NP}")
    D1 = max(D, 1)
    bins = _round4(-(-D1 // -(-D1 // tile_bins_cap(NP))))
    tiles = -(-D1 // bins)
    room = ((MAX_SMEM - tile_smem(NP, bins, 0))
            // ((1 + NP) * TILE_CHUNK * 4 + 2 * _MBAR))
    stages = max(MIN_STAGES, min(MAX_STAGES, -(-N // TILE_CHUNK), room))
    return TilePlan(tiles, bins, stages, tile_smem(NP, bins, stages))


@dataclasses.dataclass(frozen=True)
class RowPlan:
    """P2's launch plan: route "staged" (the whole row in shared memory,
    one slot per piece) or "ring" (`slots` slots reused), `smem` dynamic
    shared bytes."""

    route: str
    slots: int
    smem: int

    def args(self) -> tuple[int, ...]:
        """The plan as `dagcon_hist_row` takes it."""
        return (self.slots, self.smem)

    def describe(self) -> str:
        return f"{self.route} slots={self.slots} smem={self.smem}"


def row_plane(D: int) -> int:
    """Words of P2's bins (bin 0 up to 3 words in, at the output row's
    16-byte alignment)."""
    return _round4(D) + 4


def staged_words(N: int) -> int:
    """Words of the staged route's slots: piece c at c * ROW_CHUNK, the
    middle of any row at most N & ~3 values."""
    return N & ~3


def row_smem(N: int, D: int, slots: int) -> int:
    """P2's dynamic shared bytes: the slots (the ring's when slots are
    fewer than the pieces), the bins, two mbarriers a slot."""
    ring = slots < -(-N // ROW_CHUNK)
    words = slots * ROW_CHUNK if ring else staged_words(N)
    return words * 4 + row_plane(D) * 4 + 2 * slots * _MBAR


def hist_row_plan(N: int, D: int) -> RowPlan:
    """P2's plan for rows of N values into D <= MAX_ROW_BINS bins: the
    whole row staged beside the bins where both fit one CTA ("staged"),
    else a ring of as many slots as fit, fewer than the pieces and at
    least 2 ("ring"). Raises where the row's slots do not fit."""
    if not 0 <= D <= MAX_ROW_BINS:
        raise ValueError(f"hist_v2 holds a row's histogram in shared memory: "
                         f"D <= {MAX_ROW_BINS}, got {D}")
    pieces = -(-N // ROW_CHUNK)
    staged = max(pieces, 1)
    if row_smem(N, D, staged) <= MAX_SMEM:
        return RowPlan("staged", staged, row_smem(N, D, staged))
    room = (MAX_SMEM - row_plane(D) * 4) // (ROW_CHUNK * 4 + 2 * _MBAR)
    slots = min(room, pieces - 1)
    if slots < 2:
        raise ValueError(f"{D} bins leave no room for the row's slots")
    return RowPlan("ring", slots, row_smem(N, D, slots))


def _check_extent(N: int, D: int) -> None:
    if N > MAX_EXTENT or D > MAX_EXTENT:
        raise ValueError(f"kernel takes N, D <= 2^30; got N={N}, D={D}")


def _hist(fn: str, name: str, values: torch.Tensor, D: int,
          plan) -> torch.Tensor:
    B, N = _dims(values, D)
    _check_extent(N, D)
    _check_rows(values, "values", (B, N), values.device)
    lib = _build.load("pk_variants")
    out = torch.empty((B, D), dtype=torch.int32, device=values.device)
    if out.numel():
        with torch.cuda.device(values.device):
            stream = torch.cuda.current_stream(values.device).cuda_stream
            rc = getattr(lib, fn)(values.data_ptr(), out.data_ptr(), B, N, D,
                                  *plan, stream)
        _build.check(lib, rc, f"{name} launch")
        launches[name] += 1
    return out


def hist_v1_cuda(values: torch.Tensor, D: int) -> torch.Tensor:
    """[B, D] int32 counts of each row's values in [0, D) (others
    dropped) by the tensor-core kernel. values: [B, N] int32,
    contiguous."""
    return _hist("dagcon_hist_wgmma", "hist_v1", values, D, hist_v1_plan(D))


def hist_v2_cuda(values: torch.Tensor, D: int, *,
                 plan: RowPlan | None = None) -> torch.Tensor:
    """As `hist_v1_cuda`, by the one-CTA-per-row kernel; D <=
    MAX_ROW_BINS. `plan` overrides `hist_row_plan`."""
    if D > MAX_ROW_BINS:
        raise ValueError(f"hist_v2 holds a row's histogram in shared memory: "
                         f"D <= {MAX_ROW_BINS}, got {D}")
    if plan is None:
        plan = hist_row_plan(values.shape[-1], D)
    return _hist("dagcon_hist_row", "hist_v2", values, D, plan.args())


def scatter_tile_cuda(
    ranks: torch.Tensor, payloads: tuple[torch.Tensor, ...], D: int,
    cut_mask: int, *, plan: TilePlan | None = None,
) -> tuple[torch.Tensor, ...]:
    """out[k][b, ranks[b, n]] += payloads[k][b, n] & cut_mask, int32 with
    wraparound, by the tiled kernel; ranks outside [0, D) dropped. ranks
    and each payload: [B, N] int32, contiguous; 1 to 4 payloads. Returns
    one [B, D] int32 tensor per payload. `plan` overrides `tile_plan`."""
    B, N = _check_scatter(ranks, payloads, D, cut_mask)
    _check_extent(N, D)
    NP = len(payloads)
    plan = plan or tile_plan(N, D, NP)
    lib = _build.load("pk_variants")
    outs = tuple(
        torch.empty((B, D), dtype=torch.int32, device=ranks.device)
        for _ in payloads
    )
    if outs[0].numel():
        p_arr = (ctypes.c_void_p * NP)(*(p.data_ptr() for p in payloads))
        o_arr = (ctypes.c_void_p * NP)(*(o.data_ptr() for o in outs))
        with torch.cuda.device(ranks.device):
            stream = torch.cuda.current_stream(ranks.device).cuda_stream
            rc = lib.dagcon_scatter_tile(
                ranks.data_ptr(), p_arr, o_arr, NP, B, N, D, cut_mask,
                *plan.args(), stream,
            )
        _build.check(lib, rc, f"pallas_scatter launch ({plan.describe()})")
        launches["pallas_scatter"] += 1
    return outs
