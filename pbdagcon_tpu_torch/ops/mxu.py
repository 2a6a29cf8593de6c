"""Histograms, known-rank scatters and clamped gathers of the device
graph build (port of `pbdagcon_tpu/ops/mxu.py`).

The function names and signatures are those of the JAX counterpart, so
that the build's call sites read one to one. The contracts are the exact
ones of its XLA forms:

- `mxu_hist`: out[b, d] = #{n : valid[b, n] and values[b, n] == d} for
  d in [0, D); values < 0 or >= D are dropped.
- `mxu_scatter` / `mxu_weighted_hist`: each payload is cut to its low
  8 * nbytes bits (nbytes from `max_payload` / `max_weight`), then
  summed into out[k][b, ranks[b, n]] with int32 wraparound; ranks < 0,
  masked off or >= D are dropped. Unique ranks make this a transport,
  repeated ranks a sum.
- `mxu_gather` / `mxu_gather_planes`: out[b, n] = tbl[b, idx[b, n]] with
  the index clipped to [0, ceil(T/128)*128 - 1], the padded tail
  [T, ceil(T/128)*128) and masked-off indices reading 0, and the value
  cut to 8 * nbytes bits.

On a CUDA tensor every histogram and scatter goes to its hand-written
kernel (`ops/mxu_cuda.py`, `csrc/hist_scatter.cu`), which raises if it
cannot run; on a CPU tensor to its plain PyTorch version below
(`scatter_add_` on integers: no matmul, so no TF32 rounding can reach a
count). Both take the `valid` mask as it is given and read it
themselves, as XLA fuses the TPU form's `where` into the kernel's input.
There is no fallback from one to the other. The gathers are
`torch.gather` on both; the TPU needed the one-hot forms only because
its hardware gather was slow.
"""

from __future__ import annotations

import torch

I32 = torch.int32
_LANES = 128


def _nbytes(max_val: int) -> int:
    n = max(1, -(-max(1, max_val - 1).bit_length() // 8))
    if n > 4:
        raise ValueError(f"values past 32 bits (max {max_val}) do not fit int32")
    return n


def _cut_mask(nbytes: int) -> int:
    """The low 8 * nbytes bits, as an unsigned 32-bit mask."""
    return (1 << (8 * nbytes)) - 1


def _cut(x: torch.Tensor, nbytes: int) -> torch.Tensor:
    """int32 x cut to its low 8 * nbytes bits (a no-op at 4 bytes)."""
    return x if nbytes >= 4 else x & _cut_mask(nbytes)


def _wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 with two's-complement wraparound."""
    x = x & 0xFFFFFFFF
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(I32)


# ---- plain PyTorch versions of the kernels -------------------------------


def _ok(idx: torch.Tensor, valid, D: int) -> torch.Tensor:
    """Elements that count: valid (where a mask is given) and in [0, D)."""
    ok = (idx >= 0) & (idx < D)
    return ok if valid is None else ok & valid


def hist_reference(values: torch.Tensor, valid, D: int) -> torch.Tensor:
    """Plain version of the hist kernel: [B, N] int32 -> [B, D] int32
    counts of the valid values in [0, D) (others dropped; `valid` a bool
    mask broadcastable to [B, N], or None)."""
    B = values.shape[0]
    ok = _ok(values, valid, D)
    idx = torch.where(ok, values, torch.full_like(values, D)).long()
    out = torch.zeros((B, D + 1), dtype=I32, device=values.device)
    out.scatter_add_(1, idx, ok.to(I32))
    return out[:, :D].contiguous()


def scatter_reference(
    ranks: torch.Tensor, valid, payloads: tuple[torch.Tensor, ...], D: int,
    cut_mask: int,
) -> tuple[torch.Tensor, ...]:
    """Plain version of the scatter kernel: out[k][b, ranks[b, n]] +=
    payloads[k][b, n] & cut_mask over valid n, in int32 with wraparound
    (summed in int64, then wrapped); ranks outside [0, D) dropped."""
    B = ranks.shape[0]
    ok = _ok(ranks, valid, D)
    idx = torch.where(ok, ranks, torch.full_like(ranks, D)).long()
    outs = []
    for p in payloads:
        acc = torch.zeros((B, D + 1), dtype=torch.int64, device=ranks.device)
        acc.scatter_add_(1, idx, torch.where(ok, p.long() & cut_mask, 0))
        outs.append(_wrap_i32(acc[:, :D]).contiguous())
    return tuple(outs)


# ---- dispatchers ---------------------------------------------------------


def _hist(v: torch.Tensor, valid, D: int) -> torch.Tensor:
    v = v.to(I32)
    if v.device.type == "cuda":
        from pbdagcon_tpu_torch.ops.mxu_cuda import hist_cuda

        return hist_cuda(v.contiguous(), valid, D)
    if v.device.type == "cpu":
        return hist_reference(v, valid, D)
    raise ValueError(f"no histogram for device {v.device}")


def _scatter(r: torch.Tensor, valid, payloads, D: int, nbytes: int):
    r = r.to(I32)
    ps = tuple(p.to(I32) for p in payloads)
    mask = _cut_mask(nbytes)
    if r.device.type == "cuda":
        from pbdagcon_tpu_torch.ops.mxu_cuda import scatter_cuda

        return scatter_cuda(
            r.contiguous(), valid, tuple(p.contiguous() for p in ps), D, mask
        )
    if r.device.type == "cpu":
        return scatter_reference(r, valid, ps, D, mask)
    raise ValueError(f"no scatter for device {r.device}")


def mxu_hist(values, valid, D, *, chunk: int = 4096):
    """Counts per value over domain [0, D): [B, N] -> [B, D] int32.
    (`chunk` is the JAX form's tiling and is not used.)"""
    return _hist(values, valid, D)


def hist_lohi(values, valid, D, *, chunk: int = 4096):
    """(lo, hi) over the full grid 0..D-1: lo[d] = #{v < d},
    hi[d] = #{v <= d}."""
    h = mxu_hist(values, valid, D)
    hi = torch.cumsum(h, dim=-1, dtype=I32)
    return hi - h, hi


def mxu_weighted_hist(values, valid, weights, D, *,
                      max_weight: int = 1 << 31):
    """out[k][b, d] = sum of weights[k][b, n] (cut to the bytes that
    `max_weight` needs) over valid n with values[b, n] == d; values may
    repeat. Returns a tuple of [B, D] int32."""
    return _scatter(values, valid, weights, D, _nbytes(max_weight))


def mxu_scatter(ranks, valid, payloads, D, *, chunk: int = 4096,
                max_payload: int = 1 << 16):
    """Transport payloads to known destination ranks: out[k][b,
    ranks[b, n]] = payloads[k][b, n] for unique valid ranks (a sum where
    ranks repeat), payloads cut to the bytes `max_payload` needs. Cells
    with no source read 0. Returns a tuple of [B, D] int32."""
    return _scatter(ranks, valid, payloads, D, _nbytes(max_payload))


def mxu_scatter_presence(ranks, valid, D, *, chunk: int = 4096):
    """out[b, d] = number of valid n with ranks[b, n] == d."""
    return mxu_hist(ranks, valid, D)


def _gather_padded(tbl: torch.Tensor, ic: torch.Tensor) -> torch.Tensor:
    """tbl[..., ic] for ic in [0, ceil(T/128)*128); the tail past T
    reads 0."""
    T = tbl.shape[-1]
    g = torch.gather(tbl.to(I32), -1, ic.clamp(max=T - 1).long())
    return torch.where(ic < T, g, torch.zeros_like(g))


def mxu_gather(tbl, idx, *, max_val: int, valid=None):
    """out[b, n] = tbl[b, idx[b, n]], the index clipped to the padded
    table, the padded tail and masked-off indices reading 0, the value
    cut to the bytes `max_val` needs."""
    TP = -(-tbl.shape[-1] // _LANES) * _LANES
    ic = idx.to(I32).clamp(0, TP - 1)
    out = _cut(_gather_padded(tbl, ic), _nbytes(max_val))
    if valid is not None:
        out = torch.where(valid, out, torch.zeros_like(out))
    return out


def mxu_gather_planes(tables, idx):
    """Gather many tables at one shared index: out[k][b, n] =
    tables[k][0][b, idx[b, n]], each cut to tables[k][1] bytes, the
    index clipped to the padded table as in `mxu_gather`."""
    TP = -(-tables[0][0].shape[-1] // _LANES) * _LANES
    ic = idx.to(I32).clamp(0, TP - 1)
    return [_cut(_gather_padded(tbl, ic), nbytes) for tbl, nbytes in tables]
