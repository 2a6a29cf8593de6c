"""The kernel-variant microbench's histograms and scatter (port of the
kernels of `tools/prof_pk.py`), under the JAX tool's names.

- `hist_v0`: B2, the devbuild build's histogram (`_pallas_hist` there,
  `ops/mxu_cuda.py::hist_cuda` here);
- `hist_v1` (P1): the factorized one-hot product, on the tensor cores;
- `hist_v2` (P2): one CTA per row, the row staged on chip at once by
  TMA bulk copies beside its whole histogram;
- `pallas_scatter` (P3): the payload scatter over D tiles, one CTA per
  tile accumulating it on chip, each staging the row's aligned middle by
  TMA bulk copies (so each tile re-reads the row).

The contracts are those of `ops/mxu.py`: a histogram counts each row's
values in [0, D) and drops the rest; the scatter sums each payload's low
8 * nbytes bits into out[k][b, ranks[b, n]] with int32 wraparound and
drops ranks outside [0, D). A CUDA tensor goes to the kernel
(`ops/pk_cuda.py`, `csrc/pk_variants.cu`), which raises if it cannot run;
a CPU tensor to the plain version (`mxu.hist_reference`,
`mxu.scatter_reference`); any other device raises. `nc` and `dh_blk` are
the TPU kernels' tiling and are not used.
"""

from __future__ import annotations

import torch

from pbdagcon_tpu_torch.ops import mxu, pk_cuda


def _on_card(t: torch.Tensor) -> bool:
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no kernel or plain version for device {t.device}")
    return t.device.type == "cuda"


def hist_v0(values: torch.Tensor, D: int, nc: int = 2048) -> torch.Tensor:
    """[B, N] int32 -> [B, D] int32 counts by B2 (the build's kernel)."""
    return mxu._hist(values, None, D)


def hist_v1(values: torch.Tensor, D: int, nc: int = 2048) -> torch.Tensor:
    """[B, N] int32 -> [B, D] int32 counts by P1 (tensor cores)."""
    if _on_card(values):
        return pk_cuda.hist_v1_cuda(values.contiguous(), D)
    return mxu.hist_reference(values, None, D)


def hist_v2(values: torch.Tensor, D: int, nc: int = 2048) -> torch.Tensor:
    """[B, N] int32 -> [B, D] int32 counts by P2 (one CTA per row, the
    row staged beside the bins; D <= pk_cuda.MAX_ROW_BINS on the
    card)."""
    if _on_card(values):
        return pk_cuda.hist_v2_cuda(values.contiguous(), D)
    return mxu.hist_reference(values, None, D)


def pallas_scatter(ranks: torch.Tensor, payloads, D: int, nbytes: int,
                   nc: int = 2048, dh_blk=None) -> tuple[torch.Tensor, ...]:
    """out[k][b, ranks[b, n]] += low 8 * nbytes bits of payloads[k][b, n]
    by P3, int32 with wraparound; ranks outside [0, D) dropped. Returns a
    tuple of [B, D] int32."""
    if not 1 <= nbytes <= 4:
        raise ValueError(f"nbytes must be 1..4, got {nbytes}")
    mask = mxu._cut_mask(nbytes)
    ps = tuple(p.to(mxu.I32) for p in payloads)
    if _on_card(ranks):
        return pk_cuda.scatter_tile_cuda(
            ranks.contiguous(), tuple(p.contiguous() for p in ps), D, mask
        )
    return mxu.scatter_reference(ranks, None, ps, D, mask)
