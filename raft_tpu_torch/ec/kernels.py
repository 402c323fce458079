"""Kernels K6 and K7: the RS codec's constant GF(2^8) matrix apply (port of
``raft_tpu/ec/kernels.py``).

Multiplication by a constant c is GF(2)-linear in the bits of x, so
``mul(c, x) = XOR over set bits i of x of mul(c, 1 << i)``: one (output
row, input row) term is 8 bit tests and XORs, and the per-code constants
``mul(M[r, j], 1 << i)`` (``_bit_consts``) are all the plain versions
need. It is also a function of one byte, so the kernel looks it up
instead: ``gf_tables`` packs ``mul(M[r, j], x)`` for four output rows r
into one u32 per (input row j, byte x), and the kernel builds those
tables on chip from their single-bit entries (``gf_bits``).

- K6 (``csrc/ec.cu`` ``gf_table_kernel``; replaces ``_parity_pallas`` :77)
  applies such a matrix to k shard rows: the parity encode
  (``encode_device``) and, with a decode matrix, the reconstruction
  decode (``decode_device``, replacing ``decode_pallas`` :240). Its source
  is described by a ``GfSource`` (row offsets, entry stride, a ring's
  capacity and start slot), so ``decode_ring`` decodes a window of the
  log ring in place, seam included, with no gather; its output by a
  ``GfOutput`` (base, row and entry strides).
- K7 (the same kernel with its input rows passed through; replaces
  ``_encode_fold_pallas`` :161) encodes raw entries straight into the
  folded log layout (``encode_fold_device``, described by
  ``encode_fold_layout``).

Each wrapper launches its kernel for a CUDA tensor and runs the plain
bit-sliced version (``encode_bitwise`` / ``decode_bitwise``, the
select-and-XOR of ``_mul_const_bits`` :51 in torch ops) for a CPU tensor.
``gf_apply_plain`` is the described apply in plain form (it gathers by
the ``GfSource`` and scatters by the ``GfOutput``), so the tests hold the
kernel's layouts on the CPU. The folds (``fold_shards_device``,
``fold_data_lanes``) are views of contiguous bytes as little-endian int32
words and need no kernel.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from raft_tpu_torch import cuda_build
from raft_tpu_torch.ec import gf
from raft_tpu_torch.ec.rs import RSCode

#: kernel launches, counted where each wrapper launches its kernel (K6
#: counts its two uses apart)
LAUNCHES = {"encode": 0, "decode": 0, "encode_fold": 0}

#: rows in and out of one matrix apply on the card (``csrc/ec.cu``)
MAX_ROWS = 16


def _bit_consts(matrix: np.ndarray) -> np.ndarray:
    """u8[rows, cols, 8]: consts[r, c, i] = mul(matrix[r, c], 1 << i)."""
    rows, cols = matrix.shape
    out = np.zeros((rows, cols, 8), np.uint8)
    for r in range(rows):
        for c in range(cols):
            for i in range(8):
                out[r, c, i] = int(gf.mul(matrix[r, c], np.uint8(1 << i)))
    return out


@lru_cache(maxsize=None)
def _parity_consts_key(n: int, k: int) -> bytes:
    """Per-code parity bit-decomposition constants, computed once."""
    return _bit_consts(RSCode(n, k).parity_matrix).tobytes()


@lru_cache(maxsize=None)
def _decode_consts_key(n: int, k: int, rows: tuple) -> bytes:
    """Bit-decomposition constants of decode_matrix(rows), cached per
    (code, serving-row subset) — there are only C(n, k) of them."""
    return _bit_consts(RSCode(n, k).decode_matrix(list(rows))).tobytes()


def gf_tables(matrix: np.ndarray) -> np.ndarray:
    """u32[cols, ceil(rows / 4), 256]: entry x of table (j, g) holds
    mul(matrix[4g + q, j], x) in byte q, for the output rows 4g + q that
    exist (K6's lookup tables)."""
    rows, cols = matrix.shape
    x = np.arange(256, dtype=np.uint8)
    out = np.zeros((cols, -(-rows // 4), 256), np.uint32)
    for r in range(rows):
        for j in range(cols):
            out[j, r // 4] |= gf.mul(matrix[r, j], x).astype(np.uint32) \
                << np.uint32(8 * (r % 4))
    return out


def gf_bits(matrix: np.ndarray) -> np.ndarray:
    """u32[cols, ceil(rows / 4), 8]: the single-bit entries of
    ``gf_tables(matrix)`` (entry 1 << b of each table), from which the
    kernel builds every table on chip: entry x is their XOR over the set
    bits b of x."""
    return np.ascontiguousarray(gf_tables(matrix)[:, :, 1 << np.arange(8)])


def _matrix(n: int, k: int, rows) -> np.ndarray:
    """The parity matrix for ``rows=None``, else decode_matrix(rows) in
    the caller's row order."""
    code = RSCode(n, k)
    return code.parity_matrix if rows is None else code.decode_matrix(
        list(rows))


@lru_cache(maxsize=None)
def _bits_of(n: int, k: int, rows) -> np.ndarray:
    """K6's table constants, once per (code, row set)."""
    return gf_bits(_matrix(n, k, rows))


def parity_consts(n: int, k: int) -> np.ndarray:
    """u8[n-k, k, 8] with ``[p, j, i] = mul(P[p, j], 1 << i)``: the table
    of the steady kernels' in-kernel parity (``core.step_cuda``
    ``ec_consts``) and of K6's encode."""
    return np.frombuffer(_parity_consts_key(n, k), np.uint8).reshape(
        n - k, k, 8)


def decode_consts(n: int, k: int, rows) -> np.ndarray:
    """u8[k, k, 8]: the table of K6's decode for serving ``rows``."""
    rows = tuple(int(r) for r in rows)
    return np.frombuffer(_decode_consts_key(n, k, rows), np.uint8).reshape(
        k, k, 8)


# ------------------------------------------------------------ plain core
def apply_bits_plain(consts: np.ndarray, src: torch.Tensor) -> torch.Tensor:
    """The plain matrix apply: u8[k, ...] input rows -> u8[rows, ...],
    ``out[r] = XOR_j mul(M[r, j], src[j])`` with M given by its bit table
    ``consts`` u8[rows, k, 8] — bit test, select and XOR, as
    ``_mul_const_bits``."""
    rows, k, _ = consts.shape
    outs = []
    for r in range(rows):
        acc = torch.zeros_like(src[0])
        for j in range(k):
            x = src[j]
            for i in range(8):
                c = int(consts[r, j, i])
                if c:
                    cu = torch.tensor(c, dtype=torch.uint8, device=x.device)
                    acc ^= torch.where((x & (1 << i)) != 0, cu, 0)
        outs.append(acc)
    return torch.stack(outs)


def _entries(code: RSCode, data: torch.Tensor) -> torch.Tensor:
    """u8[B, S] -> its k data shards u8[k, B, S/k] (a view)."""
    B, S = data.shape
    if S % code.k:
        raise ValueError(f"entry bytes {S} must divide by k={code.k}")
    return data.reshape(B, code.k, S // code.k).permute(1, 0, 2)


def encode_bitwise(code: RSCode, data: torch.Tensor) -> torch.Tensor:
    """The plain version of K6 encode: u8[B, S] -> u8[n, B, S/k]."""
    d = _entries(code, data)
    parity = apply_bits_plain(parity_consts(code.n, code.k), d)
    return torch.cat([d, parity])


def decode_bitwise(code: RSCode, shards: torch.Tensor, rows) -> torch.Tensor:
    """The plain version of K6 decode: u8[k, B, Sk] shards from ``rows``
    -> u8[B, k*Sk] entries."""
    out = apply_bits_plain(decode_consts(code.n, code.k, rows), shards)
    k, b, sk = out.shape
    return out.permute(1, 0, 2).reshape(b, k * sk)


def fold_shards_device(shards: torch.Tensor) -> torch.Tensor:
    """u8[R, B, Sk] shard rows -> i32[B, R*Wk], the log payload layout
    (little-endian words, as numpy's ``view(np.int32)``)."""
    r, b, sk = shards.shape
    return shards.permute(1, 0, 2).reshape(b, r * sk).view(torch.int32)


def fold_data_lanes(data: torch.Tensor) -> torch.Tensor:
    """u8[B, S] raw entry bytes -> i32[B, S/4]: the systematic data-lane
    blocks of the folded layout, the window format of the steady kernels'
    in-kernel parity mode."""
    b, s = data.shape
    return data.contiguous().view(torch.int32).reshape(b, s // 4)


def encode_fold_plain(code: RSCode, data: torch.Tensor) -> torch.Tensor:
    """The plain version of K7: u8[B, S] -> i32[B, n*Wk]."""
    return fold_shards_device(encode_bitwise(code, data))


# ------------------------------------------------------------- wrappers
def _check_u8(name: str, t: torch.Tensor, ndim: int, sk_dim: int) -> None:
    if t.dtype != torch.uint8 or t.dim() != ndim:
        raise ValueError(f"{name} must be a {ndim}-d uint8 tensor, got "
                         f"{t.dtype} {tuple(t.shape)}")
    if t.shape[sk_dim] % 4:
        raise ValueError(f"{name}: shard bytes {t.shape[sk_dim]} must fill "
                         "whole 4-byte words")


class GfSource(NamedTuple):
    """Where K6 reads its k input rows, in 4-byte words of the source: row
    j of entry i at ``slot * entry + rows[j]``, ``slot = (start + i) mod
    cap``."""

    rows: tuple
    entry: int
    cap: int
    start: int = 0


def gather_source(src: torch.Tensor, source: GfSource, n: int,
                  wk: int) -> torch.Tensor:
    """The plain form of K6's source addressing: the k input rows of
    entries [0, n) as u8[k, n, 4*wk], read from ``src`` (contiguous, any
    dtype, as flat 4-byte words) where ``source`` says."""
    flat = src.reshape(-1).view(torch.int32)
    dev = src.device
    slots = (source.start + torch.arange(n, device=dev)) % source.cap
    idx = ((slots * source.entry)[None, :, None]
           + torch.as_tensor(source.rows, device=dev)[:, None, None]
           + torch.arange(wk, device=dev))
    return flat[idx].view(torch.uint8).reshape(len(source.rows), n, 4 * wk)


class GfOutput(NamedTuple):
    """Where K6 writes, in 4-byte words of the output: output row r of
    entry i at ``base + r * row + i * entry``; with ``passthrough`` the k
    input rows too, input row j at ``base + (j - k) * row + i * entry``
    (K7's systematic words, stored from the registers the lookups read)."""

    base: int
    row: int
    entry: int
    passthrough: bool = False


def encode_fold_layout(code: RSCode, B: int, wk: int):
    """K7 as a described apply: raw entries u8[B, k*Wk*4] (row j at word
    ``j * Wk`` of entry i, entry stride ``k * Wk``) in, the folded layout
    i32[B, n*Wk] out — the m parity rows from word ``k * Wk`` of each
    entry, the k data rows passed through before them, row stride Wk,
    entry stride ``n * Wk``."""
    return (GfSource(tuple(j * wk for j in range(code.k)), code.k * wk,
                     max(B, 1)),
            GfOutput(code.k * wk, wk, code.n * wk, passthrough=True))


def gf_apply_plain(consts: np.ndarray, src: torch.Tensor, source: GfSource,
                   out: torch.Tensor, output: GfOutput, n: int,
                   wk: int) -> None:
    """The plain form of K6's described apply: the k input rows of entries
    [0, n) gathered where ``source`` says, ``apply_bits_plain`` with the
    bit table ``consts`` u8[rows, k, 8], and every row stored where
    ``output`` says into ``out`` (contiguous, any dtype, as flat 4-byte
    words)."""
    x = gather_source(src, source, n, wk)              # u8[k, n, 4*wk]
    rows = [apply_bits_plain(consts, x)]
    first = 0
    if output.passthrough:
        rows.insert(0, x)
        first = -len(source.rows)
    y = torch.cat(rows).view(torch.int32)              # i32[rows, n, wk]
    dev = out.device
    idx = (output.base
           + torch.arange(first, first + y.shape[0], device=dev)[:, None,
                                                                  None]
           * output.row
           + torch.arange(n, device=dev)[None, :, None] * output.entry
           + torch.arange(wk, device=dev))
    out.reshape(-1).view(torch.int32)[idx.reshape(-1)] = y.reshape(-1)


def _gf_apply(code: RSCode, rows, rows_out: int, src: torch.Tensor,
              source: GfSource, out: torch.Tensor, output: GfOutput, n: int,
              wk: int, what: str) -> None:
    """Launch K6 (``rt_gf_apply``) with the matrix of ``code`` and
    ``rows`` (``_matrix``): ``n`` entries of ``wk`` words read where
    ``source`` says, written where ``output`` says."""
    k = len(source.rows)
    if k > MAX_ROWS or rows_out > MAX_ROWS:
        raise ValueError(f"{what}: at most {MAX_ROWS} rows in and out")
    for t in (src, out):
        if t.data_ptr() % 4 or t.numel() * t.element_size() >= 2 ** 33:
            raise ValueError(f"{what}: tensors must be 4-byte aligned and "
                             "index in 32-bit words")
    evens = (*source.rows, source.entry, output.base, output.row,
             output.entry, wk)
    vec = 2 if all(o % 2 == 0 for o in evens) and all(
        t.data_ptr() % 8 == 0 for t in (src, out)) else 1
    bits = _bits_of(code.n, code.k, rows)
    rc = cuda_build.lib("ec").rt_gf_apply(
        src.data_ptr(), (ctypes.c_int * k)(*source.rows), k, source.entry,
        source.cap, source.start, out.data_ptr() + 4 * output.base,
        output.row, output.entry, bits.ctypes.data_as(ctypes.c_void_p),
        rows_out, n, wk, vec, int(output.passthrough),
        cuda_build.stream_of(src))
    cuda_build.check("ec", rc, what)


def encode_device(code: RSCode, data: torch.Tensor) -> torch.Tensor:
    """u8[B, S] entries -> u8[n, B, S/k] shard rows: the data rows by
    byte slicing, the parity rows by K6 (CUDA) or ``encode_bitwise``
    (CPU)."""
    if not data.is_cuda:
        return encode_bitwise(code, data)
    _check_u8("data", data, 2, 1)
    data = data.contiguous()
    B, S = data.shape
    d = _entries(code, data)
    sk = S // code.k
    if sk % 4:
        raise ValueError(f"shard bytes {sk} must fill whole 4-byte words")
    parity = torch.empty(code.m, B, sk, dtype=torch.uint8, device=data.device)
    if code.m and B:
        wk = sk // 4
        src = GfSource(tuple(j * wk for j in range(code.k)), code.k * wk, B)
        _gf_apply(code, None, code.m, data, src, parity,
                  GfOutput(0, B * wk, wk), B, wk, "encode_device")
        LAUNCHES["encode"] += 1
    return torch.cat([d, parity])


def decode_device(code: RSCode, shards: torch.Tensor, rows) -> torch.Tensor:
    """u8[k, B, Sk] shards from ``rows`` -> u8[B, S] entries: K6 with the
    decode matrix of ``rows``, writing the entry layout directly (CUDA), or
    ``decode_bitwise`` (CPU)."""
    rows = _row_set(code, rows)
    if not shards.is_cuda:
        return decode_bitwise(code, shards, rows)
    _check_u8("shards", shards, 3, 2)
    shards = shards.contiguous()
    k, B, sk = shards.shape
    wk = sk // 4
    src = GfSource(tuple(j * B * wk for j in range(k)), wk, max(B, 1))
    return _decode(code, rows, shards, src, B, wk, "decode_device")


def decode_ring(code: RSCode, src: torch.Tensor, source: GfSource, n: int,
                wk: int, rows) -> torch.Tensor:
    """u8[n, S] entries decoded from the shard rows ``rows`` of ``n``
    entries that ``source`` locates in ``src`` (a log ring, read in place:
    ``ec.reconstruct.ring_source``): K6 (CUDA), or ``gather_source`` and
    ``decode_bitwise`` (CPU)."""
    rows = _row_set(code, rows)
    if not src.is_cuda:
        return decode_bitwise(code, gather_source(src, source, n, wk), rows)
    if not src.is_contiguous():
        raise ValueError("decode_ring reads a contiguous source")
    return _decode(code, rows, src, source, n, wk, "decode_ring")


def _row_set(code: RSCode, rows) -> tuple:
    rows = tuple(int(r) for r in rows)
    if len(rows) != code.k:
        raise ValueError(f"need exactly k={code.k} shard rows, got {rows}")
    return rows


def _decode(code, rows, src, source, n, wk, what) -> torch.Tensor:
    out = torch.empty(n, code.k * 4 * wk, dtype=torch.uint8,
                      device=src.device)
    if n:
        _gf_apply(code, rows, code.k, src, source, out,
                  GfOutput(0, wk, code.k * wk), n, wk, what)
        LAUNCHES["decode"] += 1
    return out


def encode_fold_device(code: RSCode, data: torch.Tensor) -> torch.Tensor:
    """Fused encode + fold: u8[B, S] -> i32[B, n*Wk], the log payload
    layout; equals ``fold_shards_device(encode_device(code, data))``. K7 on
    CUDA, ``encode_fold_plain`` on the CPU."""
    if not data.is_cuda:
        return encode_fold_plain(code, data)
    _check_u8("data", data, 2, 1)
    data = data.contiguous()
    B, S = data.shape
    if S % (4 * code.k):
        raise ValueError(f"entry bytes {S} must split into k={code.k} "
                         "shards of whole 4-byte words")
    if code.k > MAX_ROWS or code.m > MAX_ROWS or code.m < 1:
        raise ValueError(f"encode_fold_device takes 1..{MAX_ROWS} parity "
                         f"rows and at most {MAX_ROWS} data rows")
    wk = S // code.k // 4
    out = torch.empty(B, code.n * wk, dtype=torch.int32, device=data.device)
    if B:
        source, output = encode_fold_layout(code, B, wk)
        _gf_apply(code, None, code.m, data, source, out, output, B, wk,
                  "encode_fold_device")
        LAUNCHES["encode_fold"] += 1
    return out
