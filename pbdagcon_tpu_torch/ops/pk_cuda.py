"""Wrappers of the hand-written Hopper kernels of the kernel-variant
microbench (`csrc/pk_variants.cu`).

- `hist_v1_cuda` (`hist_wgmma_kernel`, s8 one-hot products on the tensor
  cores by `wgmma`, sm_90a only, under the launch plan `hist_v1_plan`)
  replaces the TPU kernel `tools/prof_pk.py::hist_v1`;
- `hist_v2_cuda` (`hist_row_kernel`, one block per row, the row's whole
  histogram in shared memory) replaces `tools/prof_pk.py::hist_v2`;
- `scatter_tile_cuda` (`scatter_tile_kernel`, grid (D tile, row), each
  tile accumulated in shared memory) replaces
  `tools/prof_pk.py::pallas_scatter`.

The contracts are those of `ops/mxu.py::hist_reference` and
`scatter_reference`, the plain versions. No wrapper falls back to them:
each checks what it is given, raises on anything its kernel does not take,
and raises if the build or the launch fails. Every kernel writes each
element of its output, so the outputs are `torch.empty`. All launch on the
current stream without synchronising.

`launches` counts each kernel's launches under the JAX tool's names.
"""

from __future__ import annotations

import ctypes

import torch

from pbdagcon_tpu_torch.ops import _build
from pbdagcon_tpu_torch.ops.mxu_cuda import _check_rows, _check_scatter, _dims

launches = {"hist_v1": 0, "hist_v2": 0, "pallas_scatter": 0}
# hist_row_kernel's shared-memory histogram (`kMaxRowBins`).
MAX_ROW_BINS = 48 * 1024
# The kernels' bound on N and D (`kMaxExtent`).
MAX_EXTENT = 1 << 30
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


def _check_extent(N: int, D: int) -> None:
    if N > MAX_EXTENT or D > MAX_EXTENT:
        raise ValueError(f"kernel takes N, D <= 2^30; got N={N}, D={D}")


def _hist(fn: str, name: str, values: torch.Tensor, D: int,
          *plan: int) -> torch.Tensor:
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
    return _hist("dagcon_hist_wgmma", "hist_v1", values, D, *hist_v1_plan(D))


def hist_v2_cuda(values: torch.Tensor, D: int) -> torch.Tensor:
    """As `hist_v1_cuda`, by the one-block-per-row kernel; D <=
    MAX_ROW_BINS."""
    if D > MAX_ROW_BINS:
        raise ValueError(f"hist_v2 holds a row's histogram in shared memory: "
                         f"D <= {MAX_ROW_BINS}, got {D}")
    return _hist("dagcon_hist_row", "hist_v2", values, D)


def scatter_tile_cuda(
    ranks: torch.Tensor, payloads: tuple[torch.Tensor, ...], D: int,
    cut_mask: int,
) -> tuple[torch.Tensor, ...]:
    """out[k][b, ranks[b, n]] += payloads[k][b, n] & cut_mask, int32 with
    wraparound, by the tiled kernel; ranks outside [0, D) dropped. ranks
    and each payload: [B, N] int32, contiguous; 1 to 4 payloads. Returns
    one [B, D] int32 tensor per payload."""
    B, N = _check_scatter(ranks, payloads, D, cut_mask)
    _check_extent(N, D)
    lib = _build.load("pk_variants")
    outs = tuple(
        torch.empty((B, D), dtype=torch.int32, device=ranks.device)
        for _ in payloads
    )
    if outs[0].numel():
        NP = len(payloads)
        p_arr = (ctypes.c_void_p * NP)(*(p.data_ptr() for p in payloads))
        o_arr = (ctypes.c_void_p * NP)(*(o.data_ptr() for o in outs))
        with torch.cuda.device(ranks.device):
            stream = torch.cuda.current_stream(ranks.device).cuda_stream
            rc = lib.dagcon_scatter_tile(
                ranks.data_ptr(), p_arr, o_arr, NP, B, N, D, cut_mask, stream
            )
        _build.check(lib, rc, "pallas_scatter launch")
        launches["pallas_scatter"] += 1
    return outs
