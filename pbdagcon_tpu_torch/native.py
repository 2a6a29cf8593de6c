"""The port's side of the native C++ engine (`native/libdagcon.so`).

The engine is the repo's C++ host side: streaming M5/'pre' parse, gap
normalization, graph build + merge, linearization, float32 DP,
backtrack, FASTA emission, multithreaded over targets. Build: `make -C
native` (plain g++); `ensure_built()` attempts it, `available()` says
whether the library loads. Both take the native directory (default: the
repo's `native/`) and are safe to call from many processes at once: a
build holds an flock on the directory's lock file and writes a
temporary library that is moved into place, so no process loads a
half-written one (several test workers load it while they collect).

`NativeEngine`, `available`, `ensure_built` and the ctypes signatures
are the port's copy of `pbdagcon_tpu/native.py`, cut to the entry
points the port calls. The batch packer is the port's own: `pack_batch`
calls `dagcon_pack_batch` into one arena laid out by the port's
`ops.dp.arena_layout`, optionally in pinned host memory so that a single
non-blocking copy uploads the whole batch. `enc_fill_packed` does the
same for the device build's encoded inputs (`dagcon_enc_fill_packed`).
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import os
import subprocess

import numpy as np
import torch

from pbdagcon_tpu_torch.ops.dp import LongEdgeOverflow, arena_layout

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "native")
_LIB_NAME = "libdagcon.so"
_LOCK_NAME = ".libdagcon.so.lock"

# Loaded libraries by native directory (None: it failed to build or load).
_libs: dict[str, ctypes.CDLL | None] = {}


@contextlib.contextmanager
def _build_lock(native_dir: str):
    """An exclusive flock on the native directory's lock file: one build
    at a time across processes."""
    fd = os.open(os.path.join(native_dir, _LOCK_NAME), os.O_CREAT | os.O_RDWR,
                 0o644)
    try:
        fcntl.flock(fd, fcntl.LOCK_EX)
        yield
    finally:
        os.close(fd)  # drops the lock


def _build_locked(native_dir: str) -> bool:
    """With the build lock held: `make` into a temporary name, then
    os.replace it into place, so the library's path only ever names a
    whole file. True on success."""
    tmp = f"{_LIB_NAME}.{os.getpid()}.tmp"
    try:
        subprocess.run(
            ["make", "-C", native_dir, "-s", f"TARGET={tmp}"],
            check=True, capture_output=True, timeout=300,
        )
        os.replace(os.path.join(native_dir, tmp),
                   os.path.join(native_dir, _LIB_NAME))
    except (subprocess.SubprocessError, OSError):
        return False
    finally:
        with contextlib.suppress(FileNotFoundError):
            os.remove(os.path.join(native_dir, tmp))
    return True


def ensure_built(force: bool = False, native_dir: str = _NATIVE_DIR) -> bool:
    """Build libdagcon.so if missing (or if `force`); True if the library
    exists after. Safe to call from many processes at once: builds take
    the build lock and write a temporary file that is moved into place."""
    path = os.path.join(native_dir, _LIB_NAME)
    if os.path.exists(path) and not force:
        return True
    with _build_lock(native_dir):
        if os.path.exists(path) and not force:  # built while we waited
            return True
        return _build_locked(native_dir)


def _open(native_dir: str) -> ctypes.CDLL | None:
    """dlopen the library, built first if missing. A library that does
    not open (a file another build, such as `make -C native` run by
    hand, has not finished) is rebuilt once under the lock."""
    path = os.path.join(native_dir, _LIB_NAME)
    if not ensure_built(native_dir=native_dir):
        return None
    try:
        return ctypes.CDLL(path)
    except OSError:
        pass
    with _build_lock(native_dir):
        if not _build_locked(native_dir):
            return None
    try:
        return ctypes.CDLL(path)
    except OSError:
        return None


def _load(native_dir: str = _NATIVE_DIR) -> ctypes.CDLL | None:
    """The library of `native_dir` with its ctypes signatures (cached
    per directory), or None if it cannot be built or loaded."""
    if native_dir in _libs:
        return _libs[native_dir]
    lib = _open(native_dir)
    if lib is not None:
        _bind(lib)
    _libs[native_dir] = lib
    return lib


def _bind(lib: ctypes.CDLL) -> None:
    c_char_pp = ctypes.POINTER(ctypes.c_char_p)
    c_long_p = ctypes.POINTER(ctypes.c_long)
    i32p = ctypes.POINTER(ctypes.c_int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    f32p = ctypes.POINTER(ctypes.c_float)

    lib.dagcon_engine_new.restype = ctypes.c_void_p
    lib.dagcon_engine_new.argtypes = [ctypes.c_int] * 4
    lib.dagcon_engine_free.argtypes = [ctypes.c_void_p]
    lib.dagcon_consensus_text.restype = ctypes.c_int
    lib.dagcon_consensus_text.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_long, ctypes.c_int,
        ctypes.c_int, c_char_pp, c_long_p,
    ]
    lib.dagcon_free.argtypes = [ctypes.c_char_p]
    lib.dagcon_linearize_text.restype = ctypes.c_int
    lib.dagcon_linearize_text.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_long, ctypes.c_int,
        ctypes.c_int,
    ]
    lib.dagcon_target_meta.restype = ctypes.c_int
    lib.dagcon_target_meta.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
        ctypes.c_char_p, ctypes.c_int,
    ]
    lib.dagcon_target_consensus.restype = ctypes.c_int
    lib.dagcon_target_consensus.argtypes = [
        ctypes.c_void_p, ctypes.c_int, f32p, ctypes.c_int, ctypes.c_int,
        c_char_pp, c_long_p,
    ]
    lib.dagcon_target_scores.restype = ctypes.c_int
    lib.dagcon_target_scores.argtypes = [ctypes.c_void_p, ctypes.c_int, f32p]
    lib.dagcon_engine_targets.restype = ctypes.c_long
    lib.dagcon_engine_targets.argtypes = [ctypes.c_void_p]
    lib.dagcon_long_counts.restype = ctypes.c_int
    lib.dagcon_long_counts.argtypes = [
        ctypes.c_void_p, ctypes.c_int, i32p, ctypes.c_int, i32p,
    ]
    i16p = ctypes.POINTER(ctypes.c_int16)
    lib.dagcon_pack_batch.restype = ctypes.c_int
    lib.dagcon_pack_batch.argtypes = [
        ctypes.c_void_p, i32p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, i16p, i16p, i16p, u8p, i32p, i32p, f32p,
    ]
    lib.dagcon_clear_linears.restype = None
    lib.dagcon_clear_linears.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.dagcon_engine_status.restype = ctypes.c_int
    lib.dagcon_engine_status.argtypes = [ctypes.c_void_p, c_long_p, c_long_p]
    lib.dagcon_encode_text.restype = ctypes.c_int
    lib.dagcon_encode_text.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_long, ctypes.c_int,
        ctypes.c_int,
    ]
    lib.dagcon_enc_meta.restype = ctypes.c_int
    lib.dagcon_enc_meta.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
        ctypes.c_char_p, ctypes.c_int,
    ]
    lib.dagcon_enc_fill_packed.restype = ctypes.c_int
    lib.dagcon_enc_fill_packed.argtypes = [
        ctypes.c_void_p, i32p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_long, u8p, i32p, u8p, u8p, i32p,
    ]
    lib.dagcon_enc_clear.restype = None
    lib.dagcon_enc_clear.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.dagcon_enc_consensus.restype = ctypes.c_int
    lib.dagcon_enc_consensus.argtypes = [
        ctypes.c_void_p, ctypes.c_int, c_char_pp, c_long_p,
    ]
    lib.dagcon_engine_set_align.restype = None
    lib.dagcon_engine_set_align.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.dagcon_engine_set_scorer.restype = None
    lib.dagcon_engine_set_scorer.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int,
    ]


def available(native_dir: str = _NATIVE_DIR) -> bool:
    return _load(native_dir) is not None


class NativeEngine:
    """One streaming engine instance (wraps `DagconEngine`)."""

    def __init__(
        self,
        min_weight: int = 8,
        min_length: int = 500,
        trim: int = 0,
        threads: int = 4,
        align: bool = False,
        scorer: str = "simple",
        affine_params: tuple[int, int, int, int] = (1, -2, -4, -1),
    ):
        lib = _load()
        if lib is None:
            raise RuntimeError("native library unavailable (make -C native)")
        self._lib = lib
        self._h = lib.dagcon_engine_new(min_weight, min_length, trim, threads)
        if align:
            lib.dagcon_engine_set_align(self._h, 1)
        if scorer == "affine":
            lib.dagcon_engine_set_scorer(
                self._h, 1, *(int(x) for x in affine_params)
            )
        self.min_weight = min_weight
        self.min_length = min_length

    def close(self) -> None:
        if self._h:
            self._lib.dagcon_engine_free(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    @property
    def targets_done(self) -> int:
        """Complete target groups consumed so far (host mode)."""
        return int(self._lib.dagcon_engine_targets(self._h))

    def status(self) -> tuple[bool, int, int]:
        """(has_error, dropped_records, dropped_groups) — loud-failure
        accounting so loader-mode callers surface problems the same way
        `consensus_text` does."""
        drec = ctypes.c_long()
        dgrp = ctypes.c_long()
        rc = self._lib.dagcon_engine_status(
            self._h, ctypes.byref(drec), ctypes.byref(dgrp)
        )
        return rc != 0, int(drec.value), int(dgrp.value)

    # -------------------------------------------------------- host mode
    def consensus_text(
        self, text: bytes, fmt: str = "m5", flush: bool = True
    ) -> str:
        """Full native consensus: text chunk in, FASTA out."""
        out = ctypes.c_char_p()
        out_len = ctypes.c_long()
        rc = self._lib.dagcon_consensus_text(
            self._h, text, len(text), 0 if fmt == "m5" else 1,
            1 if flush else 0, ctypes.byref(out), ctypes.byref(out_len),
        )
        try:
            res = ctypes.string_at(out, out_len.value).decode()
        finally:
            self._lib.dagcon_free(out)
        if rc != 0:
            raise ValueError("malformed alignment record in input")
        return res

    # ------------------------------------------------------ loader mode
    def linearize_text(
        self, text: bytes, fmt: str = "m5", flush: bool = True
    ) -> int:
        """Parse + build + merge + linearize complete groups; APPENDS to
        the retained target list and returns the number appended. Use
        `clear_linears(upto)` to release emitted targets from the front
        (later indices shift down by `upto`). Raises ValueError on
        malformed input (same policy as `consensus_text`)."""
        n = self._lib.dagcon_linearize_text(
            self._h, text, len(text), 0 if fmt == "m5" else 1,
            1 if flush else 0,
        )
        err, _, _ = self.status()
        if err:
            raise ValueError("malformed alignment record in input")
        return n

    def clear_linears(self, upto: int) -> None:
        self._lib.dagcon_clear_linears(self._h, upto)

    # ----------------------------------------------- device-build mode
    def encode_text(
        self, text: bytes, fmt: str = "m5", flush: bool = True
    ) -> int:
        """Parse + normalize + encode complete groups for the device
        graph build; appends to the retained encoded list and returns
        the number appended. Raises on malformed input."""
        n = self._lib.dagcon_encode_text(
            self._h, text, len(text), 0 if fmt == "m5" else 1,
            1 if flush else 0,
        )
        if n < 0:
            raise ValueError("malformed alignment record in input")
        return n

    def enc_metas(self, count: int, offset: int = 0) -> np.ndarray:
        """[count, 9] int32: R, max columns, backbone len, #ins bases,
        total columns, max ins-chains/read, max chain length, max
        interior transition span (DQ need), max chain starts per anchor
        (SE need)."""
        out = np.zeros((count, 9), dtype=np.int32)
        meta = (ctypes.c_int * 9)()
        for i in range(count):
            if (
                self._lib.dagcon_enc_meta(
                    self._h, offset + i, meta, None, 0
                )
                < 0
            ):
                raise IndexError(offset + i)
            out[i] = meta[:]
        return out

    def enc_sid(self, idx: int) -> str:
        sid_buf = ctypes.create_string_buffer(4096)
        meta = (ctypes.c_int * 9)()
        if self._lib.dagcon_enc_meta(self._h, idx, meta, sid_buf, 4096) < 0:
            raise IndexError(idx)
        return sid_buf.value.decode()

    def enc_clear(self, upto: int) -> None:
        self._lib.dagcon_enc_clear(self._h, upto)

    def enc_consensus(self, idx: int) -> str:
        """Exact host consensus for one encoded target (fallback)."""
        out = ctypes.c_char_p()
        out_len = ctypes.c_long()
        rc = self._lib.dagcon_enc_consensus(
            self._h, idx, ctypes.byref(out), ctypes.byref(out_len)
        )
        if rc != 0:
            raise IndexError(idx)
        try:
            return ctypes.string_at(out, out_len.value).decode()
        finally:
            self._lib.dagcon_free(out)

    def target_scores(self, idx: int, n: int) -> np.ndarray:
        """Native float32 DP for target idx; returns scores[n+1]."""
        s = np.zeros(n + 1, dtype=np.float32)
        rc = self._lib.dagcon_target_scores(
            self._h, idx, s.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        )
        if rc != 0:
            raise IndexError(idx)
        return s

    def target_consensus(self, idx: int, scores: np.ndarray) -> str:
        """Native backtrack + FASTA emission given scores[n+1]."""
        s = np.ascontiguousarray(scores, dtype=np.float32)
        out = ctypes.c_char_p()
        out_len = ctypes.c_long()
        rc = self._lib.dagcon_target_consensus(
            self._h, idx, s.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            self.min_weight, self.min_length,
            ctypes.byref(out), ctypes.byref(out_len),
        )
        if rc != 0:
            raise IndexError(idx)
        try:
            return ctypes.string_at(out, out_len.value).decode()
        finally:
            self._lib.dagcon_free(out)

    def metas(self, count: int, offset: int = 0) -> np.ndarray:
        """[count, 5] int32: n, span, n_edges, n_enter, backbone_len for
        retained targets offset..offset+count-1."""
        out = np.zeros((count, 5), dtype=np.int32)
        meta = (ctypes.c_int * 5)()
        for i in range(count):
            if (
                self._lib.dagcon_target_meta(
                    self._h, offset + i, meta, None, 0
                )
                < 0
            ):
                raise IndexError(offset + i)
            out[i] = meta[:]
        return out

    def target_sid(self, idx: int) -> str:
        sid_buf = ctypes.create_string_buffer(4096)
        meta = (ctypes.c_int * 5)()
        if self._lib.dagcon_target_meta(self._h, idx, meta, sid_buf, 4096) < 0:
            raise IndexError(idx)
        return sid_buf.value.decode()

    def long_counts(self, idx: int, ws: tuple[int, ...]) -> np.ndarray:
        """#interior edges with span > W for each W in `ws`."""
        wa = np.asarray(ws, dtype=np.int32)
        out = np.zeros(len(ws), dtype=np.int32)
        rc = self._lib.dagcon_long_counts(
            self._h, idx,
            wa.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(ws),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )
        if rc != 0:
            raise IndexError(idx)
        return out


def pack_batch(
    eng: NativeEngine,
    idxs: list[int],
    V: int,
    W: int,
    K: int,
    b_pad: int | None = None,
    pin_memory: bool = False,
) -> dict:
    """Threaded C++ packing of retained targets `idxs` into one arena
    (the contract of `NativeEngine.pack_batch`). Returns numpy views of
    the seven DP arrays, the arena as a uint8 tensor (`_arena`) and its
    `_dims` (B, V, W, K). Rows past len(idxs) up to `b_pad` stay empty.
    Raises `LongEdgeOverflow` on any target that does not fit."""
    B = len(idxs)
    Bp = max(b_pad or B, B)
    ia = np.asarray(idxs, dtype=np.int32)
    off = arena_layout(Bp, V, W, K)
    arena_t = torch.empty(off["_total"], dtype=torch.uint8, pin_memory=pin_memory)
    arena = arena_t.numpy()
    arena[off["win_count"][1] :] = 0  # the band is filled with -1 below

    def view(name, dtype, shape):
        a, b = off[name]
        return arena[a:b].view(dtype).reshape(shape)

    win = view("win_count", np.int16, (Bp, V, W))
    win[:] = -1
    exit_c = view("exit_count", np.int16, (Bp, V))
    exit_c[:] = -1
    cov = view("cov", np.int16, (Bp, V))
    unsup = view("unsup", np.uint8, (Bp, V))
    long_u = view("long_u", np.int32, (Bp, K))
    long_u[:] = -1
    long_w = view("long_w", np.int32, (Bp, K))
    long_w[:] = -1
    long_esc = view("long_esc", np.float32, (Bp, K))
    long_esc[:] = -np.inf

    def p(a, typ):
        return a.ctypes.data_as(ctypes.POINTER(typ))

    rc = eng._lib.dagcon_pack_batch(
        eng._h, p(ia, ctypes.c_int32), B, V, W, K,
        p(win, ctypes.c_int16), p(exit_c, ctypes.c_int16),
        p(cov, ctypes.c_int16), p(unsup, ctypes.c_uint8),
        p(long_u, ctypes.c_int32), p(long_w, ctypes.c_int32),
        p(long_esc, ctypes.c_float),
    )
    if rc != 0:
        raise LongEdgeOverflow(
            f"target index {idxs[rc - 1]} does not fit (V={V}, W={W}, "
            f"K={K})"
        )
    return {
        "win_count": win,
        "exit_count": exit_c,
        "cov": cov,
        "unsup": unsup.view(bool),
        "long_u": long_u,
        "long_w": long_w,
        "long_esc": long_esc,
        "_arena": arena_t,
        "_dims": (Bp, V, W, K),
    }


def enc_fill_packed(
    eng: NativeEngine,
    idxs: list[int],
    R: int,
    C: int,
    L: int,
    NI: int,
    B: int | None = None,
    pin_memory: bool = False,
) -> tuple[torch.Tensor, ...]:
    """`NativeEngine.enc_fill_packed` into (optionally pinned) tensors,
    so that each uploads with one non-blocking copy: the device build's
    inputs (ops 2-bit packed [B, R, C//4] uint8, starts [B, R] int32, bb
    [B, L] uint8, ins [B, NI] uint8, Lr [B] int32) of the encoded
    targets `idxs`; rows past len(idxs) up to B stay empty."""
    if C % 4 != 0:
        raise ValueError(f"C={C} not a multiple of 4")
    n = len(idxs)
    Bp = max(B or n, n)
    shapes = (
        ((Bp, R, C // 4), torch.uint8), ((Bp, R), torch.int32),
        ((Bp, L), torch.uint8), ((Bp, NI), torch.uint8), ((Bp,), torch.int32),
    )
    ts = tuple(
        torch.zeros(s, dtype=dt, pin_memory=pin_memory) for s, dt in shapes
    )
    ops, starts, bb, ins, Lr = (t.numpy() for t in ts)
    ia = np.asarray(idxs, dtype=np.int32)

    def p(a, typ):
        return a.ctypes.data_as(ctypes.POINTER(typ))

    rc = eng._lib.dagcon_enc_fill_packed(
        eng._h, p(ia, ctypes.c_int32), n, R, C, L, NI,
        p(ops, ctypes.c_uint8), p(starts, ctypes.c_int32),
        p(bb, ctypes.c_uint8), p(ins, ctypes.c_uint8), p(Lr, ctypes.c_int32),
    )
    if rc != 0:
        raise ValueError(f"encoded target does not fit caps (rc={rc})")
    return ts
