"""The launch plans of the microbench's P2 and P3 kernels
(`ops/pk_cuda.py::hist_row_plan`, `tile_plan`) and the piece plan by
which both stage rows with TMA bulk copies (`row_pieces`), on the CPU.

- The piece plan covers every value of a row exactly once: a head and a
  tail of fewer than 4 values each, and a middle whose chunks start on
  16-byte boundaries and hold multiples of 16 bytes, for every N mod 4
  and row start (odd and even rows of a [B, N] tensor, and views that
  start off a 16-byte boundary).
- P3's plan gives each bin exactly one tile, takes the fewest tiles
  that fit one CTA, and keeps the ring and the accumulators within the
  shared memory it asks for; P2's plan stages the row where the row and
  the bins fit one CTA, else takes the ring.
- numpy models of the kernels under their plans (each chunk's slot, the
  consumers' quads, the head and tail read apart, the tile filter, the
  unsigned adds, the write-out into an output that
  starts as garbage) equal to the plain versions: a wrong plan or piece
  split shows here, where no card is needed.

The kernels themselves are held against the plain versions on the card
in tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

from pbdagcon_tpu_torch.ops import mxu, pk_cuda


def _chunks(offset: int, N: int, chunk: int):
    """(head, nb, [(start, length)] of the middle's chunks) of a row whose
    value 0 lies `offset` values past a 16-byte boundary."""
    head, nb = pk_cuda.row_pieces(offset, N)
    return head, nb, [(s, min(chunk, nb - s)) for s in range(0, nb, chunk)]


def _edges(head: int, nb: int, N: int) -> list[int]:
    """The row's values outside the bulk-copied middle."""
    return [*range(head), *range(head + nb, N)]


@pytest.mark.parametrize("chunk", [pk_cuda.TILE_CHUNK, pk_cuda.ROW_CHUNK])
@pytest.mark.parametrize("nmod", [0, 1, 2, 3])
@pytest.mark.parametrize("base", [0, 1, 2, 3])
def test_pieces_cover_every_value_once(chunk, nmod, base):
    """Rows 0-3 of [4, N] tensors starting `base` values past a 16-byte
    boundary (odd rows start off it by N mod 4 more), N mod 4 = nmod,
    with one, several and a partial last chunk."""
    for N in (nmod, 4 + nmod, chunk - 4 + nmod, 3 * chunk + nmod,
              2 * chunk + 8 + nmod):
        for b in range(4):
            offset = base + b * N
            head, nb, chunks = _chunks(offset, N, chunk)
            assert 0 <= head < 4 and nb % 4 == 0 and 0 <= N - head - nb < 4
            assert head == N or (offset + head) % 4 == 0  # 16-byte start
            seen = np.zeros(N, np.int64)
            for j in _edges(head, nb, N):
                seen[j] += 1
            for c, (s, n) in enumerate(chunks):
                assert s == c * chunk and 0 < n <= chunk and n % 4 == 0
                assert (offset + head + s) % 4 == 0  # each copy's source
                # its slot: chunk c's own in the ring, or at c * chunk of
                # the staged route's words
                assert s + n <= pk_cuda.staged_words(N)
                seen[head + s : head + s + n] += 1
            assert (seen == 1).all()


def test_chunks_are_one_pass_of_the_consumers():
    """P3's chunk is one quad per thread of a group of 256 consumers, and
    P2's one quad per each of its 992."""
    assert pk_cuda.TILE_CHUNK == 4 * 256
    assert pk_cuda.ROW_CHUNK == 4 * 992


# The devbuild bench window's scatter calls (N, D, planes), the
# microbench's, then edges: N = 0, one value, one more bin than a tile
# holds, 8 tiles and past 8, the largest D.
WINDOW_SCATTER = [(40992, 9234, 1), (6144, 4608, 1), (4608, 4608, 1),
                  (4608, 5632, 2), (6144, 14364, 2), (4608, 5632, 1),
                  (11306, 32, 1)]
PROF_SCATTER = [(6144, 78848, 2), (6144, 5632, 2), (3072, 12 * 5632, 2)]
EDGE_SCATTER = [(0, 100, 2), (1, 1, 1), (700, 800, 1), (5000, 5000, 2),
                (40000, 4000, 3), (3000, 300, 4), (30000, 70001, 1),
                (20000, 60000, 4), (100, pk_cuda.tile_bins_cap(2) + 1, 2),
                (100, 8 * pk_cuda.tile_bins_cap(3), 3),
                (100, 8 * pk_cuda.tile_bins_cap(3) + 1, 3),
                (9000, 1_000_000, 4), (10, pk_cuda.MAX_EXTENT, 1)]


@pytest.mark.parametrize("N,D,NP", WINDOW_SCATTER + PROF_SCATTER + EDGE_SCATTER)
def test_tile_plan_invariants(N, D, NP):
    plan = pk_cuda.tile_plan(N, D, NP)
    cap = pk_cuda.tile_bins_cap(NP)
    assert plan.bins % 4 == 0 and 4 <= plan.bins <= cap
    assert pk_cuda.MIN_STAGES <= plan.stages <= pk_cuda.MAX_STAGES
    # accumulators plus the ring and the barriers, within one CTA
    ring = plan.stages * (1 + NP) * pk_cuda.TILE_CHUNK * 4
    assert plan.smem == ring + NP * (plan.bins + 4) * 4 + 16 * plan.stages
    assert plan.smem <= pk_cuda.MAX_SMEM
    # the fewest tiles that fit beside TILE_STAGES, each its own CTA
    assert plan.tiles == -(-max(D, 1) // cap)
    assert plan.stages >= min(pk_cuda.TILE_STAGES, -(-N // pk_cuda.TILE_CHUNK))
    # every bin owned by exactly one tile, none empty
    if D <= 1 << 22:
        owned = np.zeros(D, np.int64)
        for lo, hi in plan.owners(D):
            assert lo < hi or D == 0
            owned[lo:hi] += 1
        assert (owned == 1).all()
    assert (plan.tiles - 1) * plan.bins < max(D, 1) <= plan.tiles * plan.bins


@pytest.mark.parametrize("N,D,NP", WINDOW_SCATTER)
def test_window_scatters_take_one_tile_or_a_pair(N, D, NP):
    """Every scatter of the bench window fits one tile, the [6144 ->
    14364] two-plane one (115 KB of accumulators) too."""
    plan = pk_cuda.tile_plan(N, D, NP)
    assert plan.tiles == 1 and plan.bins == -(-D // 4) * 4


def test_tile_plans_of_the_microbench():
    """Tiles of up to ~180 KB of accumulators beside a ring of 4 stages
    or more: the wide scatters take 4 and 3."""
    assert pk_cuda.tile_plan(6144, 78848, 2).describe() == (
        "tiles=4 bins=19712 stages=6 smem=231552")
    assert pk_cuda.tile_plan(3072, 12 * 5632, 2).tiles == 3
    assert pk_cuda.tile_plan(6144, 5632, 2).tiles == 1
    with pytest.raises(ValueError):
        pk_cuda.tile_plan(100, 100, 5)


def _scatter_tile_model(ranks, payloads, D, cut, plan, offsets):
    """numpy model of `scatter_tile_kernel` under `plan`, each array's
    row b starting offsets[k] + b * N values past a 16-byte boundary
    (ranks first). The ranks' piece plan splits the row; a payload is
    staged when its rows share the ranks' offset, else read value by
    value. Every tile's CTA stages the same slots (garbage past each
    chunk); consumer thread q reads quad q of each slot; the head and
    tail values come from global memory; each tile keeps ranks in [lo,
    lo + width) and adds the cut payloads into uint32 accumulators, and
    writes its bins into an output that starts as garbage."""
    B, N = ranks.shape
    NP = len(payloads)
    arrays = [ranks, *payloads]
    outs = [np.full((B, D), -12345, np.int64) for _ in range(NP)]
    owners = plan.owners(D)
    for b in range(B):
        acc = np.zeros((plan.tiles, NP, plan.bins), np.uint64)
        staged = [(offsets[k] - offsets[0]) % 4 == 0 for k in range(1 + NP)]
        head, nb, chunks = _chunks(offsets[0] + b * N, N, pk_cuda.TILE_CHUNK)

        def add(rank, pv):
            for t, (lo, hi) in enumerate(owners):
                if lo <= rank < hi:
                    for k in range(NP):
                        acc[t, k, rank - lo] += np.uint64(int(pv[k]) & cut)

        for j in _edges(head, nb, N):
            add(int(ranks[b, j]), [p[b, j] for p in payloads])
        for s, n in chunks:
            slots = []
            for k, arr in enumerate(arrays):
                slot = np.full(pk_cuda.TILE_CHUNK, -777, np.int64)
                if staged[k]:
                    slot[:n] = arr[b, head + s : head + s + n]
                slots.append(slot)
            for q in range(n // 4):  # one quad per consumer thread
                for i in range(4):
                    v = head + s + 4 * q + i
                    add(int(slots[0][4 * q + i]),
                        [slots[1 + k][4 * q + i] if staged[1 + k]
                         else payloads[k][b, v] for k in range(NP)])
        for t, (lo, hi) in enumerate(owners):
            for k in range(NP):
                outs[k][b, lo:hi] = acc[t, k, : hi - lo] & np.uint64(0xFFFFFFFF)
    return [o.astype(np.uint32).view(np.int32) for o in outs]


def _narrow_plan(N: int, D: int, NP: int, tiles: int) -> pk_cuda.TilePlan:
    """A plan of about `tiles` tiles (fewer where one would be empty):
    narrow tiles on a small domain, as a caller may pass `plan=`."""
    bins = -(-(-(-D // tiles)) // 4) * 4
    stages = max(pk_cuda.MIN_STAGES, min(pk_cuda.MAX_STAGES, -(-N // pk_cuda.TILE_CHUNK)))
    return pk_cuda.TilePlan(-(-D // bins), bins, stages,
                            pk_cuda.tile_smem(NP, bins, stages))


# (N, D, NP, tiles (None: the plan's), offsets of the ranks' and payloads'
# rows): every N mod 4, rows that start on and off a 16-byte boundary, the
# payloads' rows misaligned differently from the ranks', 1 to 8 tiles.
TILE_MODEL_CASES = [
    (2048, 300, 1, None, (0, 0)), (2049, 300, 2, 3, (1, 1, 1)),
    (2050, 97, 3, 8, (2, 2, 2, 2)), (2051, 50, 4, 5, (3, 3, 3, 3, 3)),
    (1500, 64, 2, 2, (0, 1, 3)), (1021, 41, 1, 7, (3, 0)),
    (3, 20, 2, 4, (1, 2, 3)), (0, 12, 1, 6, (0, 0)),
    (301, 60001, 2, None, (1, 3, 3)),
]


@pytest.mark.parametrize("N,D,NP,tiles,offsets", TILE_MODEL_CASES)
def test_scatter_tile_model_equals_reference(N, D, NP, tiles, offsets):
    rng = np.random.default_rng(N + D + NP)
    B = 3
    r = rng.integers(-3, D + 5, (B, N)).astype(np.int32)
    r[:, ::7] = D - 1
    ps = [rng.integers(-(1 << 31), (1 << 31) - 1, (B, N)).astype(np.int32)
          for _ in range(NP)]
    cut = 0xFFFFFF
    plan = (pk_cuda.tile_plan(N, D, NP) if tiles is None
            else _narrow_plan(N, D, NP, tiles))
    got = _scatter_tile_model(r, ps, D, cut, plan, offsets)
    want = mxu.scatter_reference(torch.from_numpy(r), None,
                                 tuple(torch.from_numpy(p) for p in ps), D, cut)
    for g, w in zip(got, want):
        assert np.array_equal(g, w.numpy())


# (N, D): the window's and the microbench's histograms, P2's largest
# domain, rows past one CTA (the ring), N = 0.
ROW_SHAPES = [(64, 2052), (40960, 1026), (4608, 4608), (40992, 9234),
              (6144, 1026), (6144, 8208), (4608, 1026), (6144, 2052),
              (40960, 9234), (5000, 48 * 1024), (41000, 15000),
              (70001, 9234), (100_000, 48 * 1024), (0, 300), (1, 1)]


@pytest.mark.parametrize("N,D", ROW_SHAPES)
def test_row_plan_route_follows_the_shape(N, D):
    plan = pk_cuda.hist_row_plan(N, D)
    pieces = -(-N // pk_cuda.ROW_CHUNK)
    assert plan.smem == pk_cuda.row_smem(N, D, plan.slots)
    assert plan.smem <= pk_cuda.MAX_SMEM
    staged_fits = (pk_cuda.staged_words(N) + pk_cuda.row_plane(D)) * 4 \
        + 16 * max(pieces, 1) <= pk_cuda.MAX_SMEM
    if staged_fits:
        assert plan.route == "staged" and plan.slots == max(pieces, 1)
    else:
        assert plan.route == "ring" and 2 <= plan.slots < pieces


def test_row_plan_routes_of_the_bench_rows():
    """The bench window's N ~ 41k rows (160 KB) stage whole beside 9234
    bins (37 KB); a row of 70001 values does not, and takes the ring;
    48K bins beside 100,000 values leave room for 2 slots."""
    assert pk_cuda.hist_row_plan(40992, 9234).route == "staged"
    assert pk_cuda.hist_row_plan(70001, 9234).route == "ring"
    assert pk_cuda.hist_row_plan(100_000, 48 * 1024).slots == 2
    with pytest.raises(ValueError):
        pk_cuda.hist_row_plan(10, pk_cuda.MAX_ROW_BINS + 1)


def _hist_row_model(v: np.ndarray, D: int, plan, base: int, out_base: int):
    """numpy model of `hist_row_kernel` under `plan`: row b starts base +
    b * N values past a 16-byte boundary; warp 0 counts the head and
    tail values; each piece of the middle lands in its slot (garbage past
    it), and consumer q counts its quad q (bin 0 at the output row's
    misalignment); the bins copied into an output that starts as
    garbage."""
    B, N = v.shape
    out = np.full((B, D), -12345, np.int64)
    plane = pk_cuda.row_plane(D)
    for b in range(B):
        pad = (out_base + b * D) % 4
        bins = np.zeros(plane, np.int64)
        head, nb, chunks = _chunks(base + b * N, N, pk_cuda.ROW_CHUNK)
        for j in _edges(head, nb, N):
            if 0 <= v[b, j] < D:
                bins[pad + v[b, j]] += 1
        for s, n in chunks:
            slot = np.full(pk_cuda.ROW_CHUNK, -777, np.int64)
            slot[:n] = v[b, head + s : head + s + n]
            for q in range(n // 4):
                for x in slot[4 * q : 4 * q + 4]:
                    if 0 <= x < D:
                        bins[pad + x] += 1
        out[b] = bins[pad : pad + D]
    return out.astype(np.int32)


@pytest.mark.parametrize("N,D,base,out_base", [
    (9000, 700, 0, 0), (9001, 700, 1, 3), (8186, 33, 2, 1),
    (4095, 1026, 3, 2), (13000, 5, 1, 0), (5, 9, 3, 3),
])
def test_hist_row_model_equals_reference(N, D, base, out_base):
    rng = np.random.default_rng(N + D)
    v = rng.integers(-3, D + 300, (3, N)).astype(np.int32)
    v[:, 1::29] = D - 1
    plan = pk_cuda.hist_row_plan(N, D)
    want = mxu.hist_reference(torch.from_numpy(v), None, D).numpy()
    assert np.array_equal(_hist_row_model(v, D, plan, base, out_base), want)


def test_hist_row_model_on_the_ring():
    """A ring plan forced on a row of 5 pieces: slots reused, the same
    counts."""
    N, D = 5 * pk_cuda.ROW_CHUNK - 3, 300
    plan = pk_cuda.RowPlan("ring", 2, pk_cuda.row_smem(N, D, 2))
    rng = np.random.default_rng(5)
    v = rng.integers(-3, D + 3, (2, N)).astype(np.int32)
    want = mxu.hist_reference(torch.from_numpy(v), None, D).numpy()
    assert np.array_equal(_hist_row_model(v, D, plan, 1, 2), want)
