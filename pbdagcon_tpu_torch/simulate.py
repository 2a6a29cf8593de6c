"""Synthetic pileup generation for tests, differential fuzzing, benchmarks.

The reference ships small checked-in M5 pileups as its correctness oracle
(`test/data/*.m5`, SURVEY.md §4 — reconstructed; mount empty). Since the
reference tree is unavailable, this module generates equivalent inputs: a
random backbone, noisy reads sampled from it (substitutions/insertions/
deletions at PacBio-like rates), and exact gapped alignments of each noisy
read back to the backbone (we know the true edit script, so no aligner is
needed). Output is `Alignment` records or M5 text, both target-sorted, so
the whole pipeline — parser included — can be exercised end to end.

The port's copy of `pbdagcon_tpu/simulate.py`: the same code, with the
imports switched to the port's modules.
"""

from __future__ import annotations

import dataclasses
import random
from typing import Iterator

from pbdagcon_tpu_torch.alignment import Alignment, revcomp

_BASES = "ACGT"


@dataclasses.dataclass(frozen=True)
class NoiseProfile:
    """Per-base error rates. Defaults approximate raw PacBio CLR reads
    (~15% total error, insertion-dominated)."""

    sub: float = 0.015
    ins: float = 0.09
    dele: float = 0.045
    max_ins_run: int = 3


def random_seq(rng: random.Random, length: int) -> str:
    return "".join(rng.choice(_BASES) for _ in range(length))


def sample_read(
    rng: random.Random,
    backbone: str,
    start: int,
    end: int,
    noise: NoiseProfile,
) -> tuple[str, str]:
    """Sample a noisy read of backbone[start:end]; return (qstr, tstr)
    gapped alignment strings (target-forward), built from the true edit
    script."""
    q: list[str] = []
    t: list[str] = []
    for p in range(start, end):
        tb = backbone[p]
        # Insertions before the base.
        while rng.random() < noise.ins:
            run = rng.randint(1, noise.max_ins_run)
            for _ in range(run):
                q.append(rng.choice(_BASES))
                t.append("-")
            break
        r = rng.random()
        if r < noise.dele:
            q.append("-")
            t.append(tb)
        elif r < noise.dele + noise.sub:
            choices = [b for b in _BASES if b != tb]
            q.append(rng.choice(choices))
            t.append(tb)
        else:
            q.append(tb)
            t.append(tb)
    return "".join(q), "".join(t)


def simulate_pileup(
    rng: random.Random,
    target_id: str = "target0",
    backbone_len: int = 1000,
    coverage: int = 30,
    noise: NoiseProfile = NoiseProfile(),
    full_span_first: bool = True,
    min_read_frac: float = 0.35,
) -> tuple[str, list[Alignment]]:
    """Generate (backbone, target-sorted alignments) for one target.

    `full_span_first` guarantees at least one read spanning the whole
    backbone so `backbone_from_group` can recover every position.
    """
    backbone = random_seq(rng, backbone_len)
    alns: list[Alignment] = []
    for i in range(coverage):
        if i == 0 and full_span_first:
            start, end = 0, backbone_len
        else:
            span = rng.randint(
                max(1, int(backbone_len * min_read_frac)), backbone_len
            )
            start = rng.randint(0, backbone_len - span)
            end = start + span
        qstr, tstr = sample_read(rng, backbone, start, end, noise)
        if not qstr.replace("-", ""):
            continue
        aln = Alignment(
            id=f"read{i}",
            sid=target_id,
            tlen=backbone_len,
            start=start + 1,
            qstr=qstr,
            tstr=tstr,
        )
        alns.append(aln.recompute_end())
    return backbone, alns


def simulate_targets(
    seed: int,
    n_targets: int,
    backbone_len: int = 1000,
    coverage: int = 30,
    noise: NoiseProfile = NoiseProfile(),
) -> Iterator[tuple[str, str, list[Alignment]]]:
    """Yield (target_id, backbone, alignments) for n_targets targets."""
    rng = random.Random(seed)
    for t in range(n_targets):
        tid = f"target{t}"
        backbone, alns = simulate_pileup(
            rng, tid, backbone_len, coverage, noise
        )
        yield tid, backbone, alns


def to_m5(aln: Alignment, flip: bool = False, rng: random.Random | None = None) -> str:
    """Render an Alignment as one blasr `-m 5` line (19 fields, SPEC §1.1).

    With `flip`, emit the record in reverse-complement orientation
    (qstrand '-') so the parser's strand handling is exercised; parsing the
    line recovers the original forward-target alignment.
    """
    qstr, tstr = aln.qstr, aln.tstr
    qlen = sum(1 for c in qstr if c != "-")
    nmatch = sum(1 for a, b in zip(qstr, tstr) if a == b and a != "-")
    nmm = sum(
        1 for a, b in zip(qstr, tstr) if a != b and a != "-" and b != "-"
    )
    nins = sum(1 for a, b in zip(qstr, tstr) if b == "-" and a != "-")
    ndel = sum(1 for a, b in zip(qstr, tstr) if a == "-" and b != "-")
    tstart0 = aln.start - 1
    tend0 = aln.end  # half-open
    qstrand, tstrand = "+", "+"
    if flip:
        qstr, tstr = revcomp(qstr), revcomp(tstr)
        qstrand = "-"
        # Strand-frame coords: tstart/tend such that parse_m5 recovers
        # start = tlen - tend + 1  => tend = tlen - start + 1.
        tstart0 = aln.tlen - aln.end
        tend0 = aln.tlen - aln.start + 1
    pat = "".join(
        "|" if a == b and a != "-" else "*" for a, b in zip(qstr, tstr)
    )
    score = -5 * nmatch + 6 * (nmm + nins + ndel)
    return (
        f"{aln.id} {qlen} 0 {qlen} {qstrand} "
        f"{aln.sid} {aln.tlen} {tstart0} {tend0} {tstrand} "
        f"{score} {nmatch} {nmm} {nins} {ndel} 254 "
        f"{qstr} {pat} {tstr}"
    )


def to_pre(aln: Alignment) -> str:
    """Render as one HGAP 'pre' record (7 fields, SPEC §1.2)."""
    return (
        f"{aln.id} {aln.sid} {aln.start} {aln.end} {aln.tlen} "
        f"{aln.qstr} {aln.tstr}"
    )


def to_pre_raw(aln: Alignment) -> str:
    """'pre' record with RAW (ungapped) sequences — the `dagcon -a`
    input form, where the consumer re-aligns each pair (SPEC §1.5)."""
    return (
        f"{aln.id} {aln.sid} {aln.start} {aln.end} {aln.tlen} "
        f"{aln.qstr.replace('-', '')} {aln.tstr.replace('-', '')}"
    )


def write_m5(
    path: str,
    seed: int,
    n_targets: int,
    backbone_len: int = 1000,
    coverage: int = 30,
    noise: NoiseProfile = NoiseProfile(),
    flip_frac: float = 0.3,
) -> None:
    """Write a target-sorted M5 file of simulated pileups."""
    rng = random.Random(seed ^ 0x5EED)
    with open(path, "w") as f:
        for _tid, _bb, alns in simulate_targets(
            seed, n_targets, backbone_len, coverage, noise
        ):
            for aln in alns:
                f.write(to_m5(aln, flip=rng.random() < flip_frac) + "\n")
