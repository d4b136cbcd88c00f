"""Minimal spec-compliant FLAC encoder (host tooling and test fixtures).

Counterpart of vocal_remover_tpu/utils/flac.py, ported as it is: real
FLAC streams (STREAMINFO, frame-header CRC-8, frame CRC-16) with
CONSTANT / VERBATIM / FIXED / LPC subframes and Rice-coded residuals,
independent, left-side or mid-side stereo, so that every path of the
native decoder (native/flacdec.c) can be written. It favours simplicity
over compression (one subframe strategy per call); it is not a libFLAC
replacement.
"""

from __future__ import annotations

import numpy as np

__all__ = ["encode_flac", "write_flac"]

BLOCK = 4096


class _BitWriter:
    def __init__(self):
        self.bytes = bytearray()
        self.acc = 0
        self.nbits = 0

    def write(self, value: int, nbits: int):
        if nbits == 0:
            return
        value &= (1 << nbits) - 1
        self.acc = (self.acc << nbits) | value
        self.nbits += nbits
        while self.nbits >= 8:
            self.nbits -= 8
            self.bytes.append((self.acc >> self.nbits) & 0xFF)
        self.acc &= (1 << self.nbits) - 1

    def write_signed(self, value: int, nbits: int):
        self.write(value & ((1 << nbits) - 1), nbits)

    def write_unary(self, q: int):
        while q >= 32:
            self.write(0, 32)
            q -= 32
        self.write(1, q + 1)

    def align(self):
        if self.nbits:
            self.write(0, 8 - self.nbits)

    def getvalue(self) -> bytes:
        assert self.nbits == 0
        return bytes(self.bytes)


def _crc8(data: bytes) -> int:
    crc = 0
    for b in data:
        crc ^= b
        for _ in range(8):
            crc = ((crc << 1) ^ 0x07) & 0xFF if crc & 0x80 else (crc << 1) & 0xFF
    return crc


def _crc16(data: bytes) -> int:
    crc = 0
    for b in data:
        crc ^= b << 8
        for _ in range(8):
            crc = ((crc << 1) ^ 0x8005) & 0xFFFF if crc & 0x8000 \
                else (crc << 1) & 0xFFFF
    return crc


def _utf8_code(n: int) -> bytes:
    """FLAC's extended-UTF-8 coding of the frame number."""
    if n < 0x80:
        return bytes([n])
    for extra, lead in ((1, 0xC0), (2, 0xE0), (3, 0xF0), (4, 0xF8),
                        (5, 0xFC), (6, 0xFE)):
        if n < (1 << (5 * extra + 6 - (extra == 6))):
            out = [lead | (n >> (6 * extra)) if extra < 6 else lead]
            for i in range(extra - 1, -1, -1):
                out.append(0x80 | ((n >> (6 * i)) & 0x3F))
            return bytes(out)
    raise ValueError("frame number too large")


def _rice_param(res: np.ndarray) -> int:
    mean = float(np.mean(np.abs(res))) if len(res) else 0.0
    k = 0
    while (1 << k) < mean and k < 14:
        k += 1
    return k


def _write_residual(bw: _BitWriter, res: np.ndarray, order: int,
                    blocksize: int, method: int = 0,
                    partition_order: int = 0, escape: bool = False):
    """Residual coding: Rice (method 0, 4-bit params) or Rice2
    (method 1, 5-bit params), any partition order, optionally forcing
    escaped raw-bits partitions."""
    # a legal partition order must divide the block AND leave the first
    # partition at least one sample after the predictor warm-up
    # (partition 0 holds psamples - order residuals); clamp instead of
    # emitting a stream our own decoder rejects (count < 0)
    while partition_order > 0 and (
        blocksize % (1 << partition_order) != 0
        or (blocksize >> partition_order) <= order
    ):
        partition_order -= 1
    assert blocksize % (1 << partition_order) == 0
    bw.write(method, 2)
    bw.write(partition_order, 4)
    plen = 4 if method == 0 else 5
    esc_code = 0xF if method == 0 else 0x1F
    psamples = blocksize >> partition_order
    pos = 0
    for p in range(1 << partition_order):
        count = psamples - (order if p == 0 else 0)
        part = res[pos : pos + count]
        pos += count
        if escape:
            bw.write(esc_code, plen)
            raw = 1
            if len(part):
                raw = max(1, int(np.abs(part).max()).bit_length() + 1)
            bw.write(raw, 5)
            for v in part.tolist():
                bw.write_signed(v, raw)
            continue
        k = min(_rice_param(part), esc_code - 1)
        bw.write(k, plen)
        for v in part.tolist():
            u = (abs(v) << 1) - (1 if v < 0 else 0)  # zigzag
            bw.write_unary(u >> k)
            if k:
                bw.write(u & ((1 << k) - 1), k)


_FIXED2 = np.array([2, -1], np.int64)


def _write_subframe(bw: _BitWriter, x: np.ndarray, bps: int, method: str,
                    residual_kw: dict | None = None):
    rkw = dict(residual_kw or {})
    if len(x) % (1 << rkw.get("partition_order", 0)):
        rkw["partition_order"] = 0  # last short block: order must divide
    x = x.astype(np.int64)
    bw.write(0, 1)  # padding
    if method == "auto":
        method = "constant" if np.all(x == x[0]) else (
            "fixed2" if len(x) > 2 else "verbatim")
    if method == "constant":
        assert np.all(x == x[0])
        bw.write(0, 6)
        bw.write(0, 1)
        bw.write_signed(int(x[0]), bps)
    elif method == "verbatim":
        bw.write(1, 6)
        bw.write(0, 1)
        for v in x.tolist():
            bw.write_signed(v, bps)
    elif method == "fixed2":
        order = 2
        bw.write(8 + order, 6)
        bw.write(0, 1)
        for v in x[:order].tolist():
            bw.write_signed(v, bps)
        res = x[order:] - (2 * x[1:-1] - x[:-2])
        _write_residual(bw, res, order, len(x), **rkw)
    elif method == "lpc2":
        # order-2 LPC with coefficients 2, -1 at shift 12 — numerically
        # the fixed-2 predictor, but through the LPC decode path
        # (2 << 12 fits the 15-bit signed coefficient field)
        order, precision, shift = 2, 15, 12
        coef = (_FIXED2 << shift).astype(np.int64)
        bw.write(32 + order - 1, 6)
        bw.write(0, 1)
        for v in x[:order].tolist():
            bw.write_signed(v, bps)
        bw.write(precision - 1, 4)
        bw.write_signed(shift, 5)
        for c in coef.tolist():
            bw.write_signed(c, precision)
        pred = (coef[0] * x[1:-1] + coef[1] * x[:-2]) >> shift
        res = x[order:] - pred
        _write_residual(bw, res, order, len(x), **rkw)
    else:
        raise ValueError(f"unknown subframe method {method!r}")


def encode_flac(pcm: np.ndarray, sr: int, bps: int = 16,
                method: str = "auto", stereo: str = "independent",
                block: int = BLOCK, residual_method: int = 0,
                partition_order: int = 0, escape: bool = False) -> bytes:
    """(n, ch) int PCM -> FLAC stream bytes.

    stereo: 'independent' | 'left_side' | 'mid_side' (2 channels only).
    method: subframe strategy — 'auto', 'constant', 'verbatim',
    'fixed2', 'lpc2'.
    residual_method: 0 = Rice (4-bit params), 1 = Rice2 (5-bit).
    partition_order: residual partition order (2^po partitions/frame).
    escape: force escaped raw-bits partitions instead of Rice coding.
    """
    residual_kw = {"method": residual_method,
                   "partition_order": partition_order, "escape": escape}
    pcm = np.asarray(pcm)
    if pcm.ndim == 1:
        pcm = pcm[:, None]
    n, ch = pcm.shape
    if not (4 <= bps <= 32):
        raise ValueError("bps out of range")
    lim = 1 << (bps - 1)
    if pcm.min() < -lim or pcm.max() >= lim:
        raise ValueError("samples exceed bits_per_sample range")
    if stereo != "independent" and ch != 2:
        raise ValueError("left_side/mid_side require 2 channels")

    out = bytearray(b"fLaC")
    si = _BitWriter()
    si.write(1, 1)       # last metadata block
    si.write(0, 7)       # STREAMINFO
    si.write(34, 24)
    si.write(block, 16)
    si.write(block, 16)
    si.write(0, 24)
    si.write(0, 24)
    si.write(sr, 20)
    si.write(ch - 1, 3)
    si.write(bps - 1, 5)
    si.write(n, 36)
    for _ in range(16):
        si.write(0, 8)   # MD5 unknown
    out += si.getvalue()

    x = pcm.astype(np.int64)
    for frame_idx, start in enumerate(range(0, n, block)):
        seg = x[start:start + block]
        bs = len(seg)
        bw = _BitWriter()
        bw.write(0x3FFE, 14)
        bw.write(0, 1)   # reserved
        bw.write(0, 1)   # fixed blocking
        bw.write(7, 4)   # blocksize: explicit 16-bit field
        bw.write(0, 4)   # sample rate: from STREAMINFO
        if stereo == "left_side":
            bw.write(8, 4)
        elif stereo == "mid_side":
            bw.write(10, 4)
        else:
            bw.write(ch - 1, 4)
        bw.write(0, 3)   # sample size: from STREAMINFO
        bw.write(0, 1)   # reserved
        for b in _utf8_code(frame_idx):
            bw.write(b, 8)
        bw.write(bs - 1, 16)
        header = bw.getvalue() if bw.nbits == 0 else None
        assert header is not None  # 14+1+1+4+4+4+3+1 = 32 bits + bytes
        bw.write(_crc8(header), 8)

        if stereo == "independent":
            for c in range(ch):
                _write_subframe(bw, seg[:, c], bps, method, residual_kw)
        elif stereo == "left_side":
            side = seg[:, 0] - seg[:, 1]
            _write_subframe(bw, seg[:, 0], bps, method, residual_kw)
            _write_subframe(bw, side, bps + 1, method, residual_kw)
        else:  # mid_side
            side = seg[:, 0] - seg[:, 1]
            mid = (seg[:, 0] + seg[:, 1]) >> 1
            _write_subframe(bw, mid, bps, method, residual_kw)
            _write_subframe(bw, side, bps + 1, method, residual_kw)

        bw.align()
        frame = bw.getvalue()
        out += frame
        out += _crc16(frame).to_bytes(2, "big")

    return bytes(out)


def write_flac(path: str, wave: np.ndarray, sr: int, bps: int = 16,
               **kw):
    """Write a (C, L) or (L,) float wave in [-1, 1] as FLAC."""
    w = np.asarray(wave, np.float64)
    if w.ndim == 1:
        w = w[None, :]
    scale = float(1 << (bps - 1))
    q = np.clip(np.round(w.T * scale), -scale, scale - 1).astype(np.int64)
    data = encode_flac(q, sr, bps, **kw)
    with open(path, "wb") as f:
        f.write(data)
