"""Pure-Python FLAC decoder (port of the JAX package's ``data/flac.py``):
the no-toolchain fallback for the native decoder in ``native/wav_core.cpp``
(same lossless subset: constant / verbatim / fixed / LPC subframes, rice +
rice2 partitioned residuals, wasted bits, left-/right-/mid-side stereo
decorrelation).

Reference parity target: the reference ingests non-wav containers
through librosa/ffmpeg (``src/preprocess/feats_extraction.py:7-16``);
neither is assumed here, so FLAC (AudioSet-strong's common wire
format) is decoded natively. This module favours clarity over speed —
the hot path is the C++ core; tests cross-check the two bit-exactly.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


class _BitReader:
    """MSB-first bit reader over bytes."""

    def __init__(self, data: bytes, bit: int = 0):
        self.data = data
        self.bit = bit
        self.nbits = len(data) * 8

    def bits(self, k: int) -> int:
        if k == 0:
            return 0
        if self.bit + k > self.nbits:
            raise ValueError("truncated FLAC stream")
        byte, off = divmod(self.bit, 8)
        self.bit += k
        need = off + k
        nb = (need + 7) // 8
        acc = int.from_bytes(self.data[byte : byte + nb], "big")
        return (acc >> (nb * 8 - need)) & ((1 << k) - 1)

    def sbits(self, k: int) -> int:
        v = self.bits(k)
        return v - (1 << k) if k and v & (1 << (k - 1)) else v

    def unary(self) -> int:
        q = 0
        while True:
            if self.bit >= self.nbits:
                raise ValueError("truncated FLAC stream")
            b = (self.data[self.bit >> 3] >> (7 - (self.bit & 7))) & 1
            self.bit += 1
            if b:
                return q
            q += 1
            if q > 1 << 24:
                raise ValueError("corrupt rice code")

    def align(self) -> None:
        self.bit = (self.bit + 7) & ~7


_FIXED_COEF = {0: [], 1: [1], 2: [2, -1], 3: [3, -3, 1], 4: [4, -6, 4, -1]}


def _residual(br: _BitReader, n: int, order: int) -> list:
    method = br.bits(2)
    if method > 1:
        raise ValueError("reserved residual method")
    pbits, escape = (4, 0xF) if method == 0 else (5, 0x1F)
    po = br.bits(4)
    nparts = 1 << po
    if (n >> po) << po != n or (n >> po) < order:
        raise ValueError("bad rice partition order")
    res = []
    for part in range(nparts):
        take = (n >> po) - (order if part == 0 else 0)
        param = br.bits(pbits)
        if param == escape:
            raw = br.bits(5)
            res.extend(br.sbits(raw) if raw else 0 for _ in range(take))
        else:
            for _ in range(take):
                v = (br.unary() << param) | br.bits(param)
                res.append((v >> 1) ^ -(v & 1))
    return res


def _subframe(br: _BitReader, n: int, bps: int) -> list:
    if br.bits(1) != 0:
        raise ValueError("bad subframe padding bit")
    typ = br.bits(6)
    wasted = 0
    if br.bits(1):
        wasted = 1 + br.unary()
    bps -= wasted
    if bps <= 0 or bps > 33:
        raise ValueError("bad subframe bit depth")
    if typ == 0:  # CONSTANT
        s = [br.sbits(bps)] * n
    elif typ == 1:  # VERBATIM
        s = [br.sbits(bps) for _ in range(n)]
    elif 8 <= typ <= 12:  # FIXED
        order = typ - 8
        s = [br.sbits(bps) for _ in range(order)]
        res = _residual(br, n, order)
        coef = _FIXED_COEF[order]
        for i in range(order, n):
            s.append(sum(c * s[i - 1 - j] for j, c in enumerate(coef)) + res[i - order])
    elif typ >= 32:  # LPC
        order = (typ & 31) + 1
        s = [br.sbits(bps) for _ in range(order)]
        prec = br.bits(4) + 1
        if prec == 16:
            raise ValueError("invalid LPC precision")
        shift = br.sbits(5)
        if shift < 0:
            raise ValueError("negative LPC shift")
        coef = [br.sbits(prec) for _ in range(order)]
        res = _residual(br, n, order)
        for i in range(order, n):
            s.append((sum(c * s[i - 1 - j] for j, c in enumerate(coef)) >> shift)
                     + res[i - order])
    else:
        raise ValueError(f"reserved subframe type {typ}")
    if wasted:
        s = [v << wasted for v in s]
    return s


def decode_flac_bytes(buf: bytes) -> Tuple[np.ndarray, int]:
    """FLAC bytes -> (float32 samples [n, channels] or [n], sample_rate)."""
    if len(buf) < 42 or buf[:4] != b"fLaC":
        raise ValueError("not a FLAC stream")
    pos, last, info = 4, False, None
    while not last:
        if pos + 4 > len(buf):
            raise ValueError("truncated FLAC stream")
        h = buf[pos]
        last = bool(h & 0x80)
        typ, length = h & 0x7F, int.from_bytes(buf[pos + 1 : pos + 4], "big")
        pos += 4
        if pos + length > len(buf):
            raise ValueError("truncated FLAC stream")
        if typ == 0 and length >= 34:
            s = buf[pos : pos + 34]
            sr = (s[10] << 12) | (s[11] << 4) | (s[12] >> 4)
            channels = ((s[12] >> 1) & 0x7) + 1
            bps = (((s[12] & 1) << 4) | (s[13] >> 4)) + 1
            total = ((s[13] & 0xF) << 32) | int.from_bytes(s[14:18], "big")
            info = (sr, channels, bps, total)
        pos += length
    if info is None:
        raise ValueError("missing STREAMINFO")
    sr, channels, bps, total = info
    norm = 1.0 / float(1 << (bps - 1))

    out = []
    while pos + 2 <= len(buf):
        if buf[pos] != 0xFF or (buf[pos + 1] & 0xFC) != 0xF8:
            raise ValueError("lost frame sync")
        br = _BitReader(buf[pos:])
        br.bits(16)  # sync + reserved + blocking strategy
        bs_code, sr_code = br.bits(4), br.bits(4)
        ca, ss_code = br.bits(4), br.bits(3)
        br.bits(1)
        b0 = br.bits(8)  # UTF-8 coded number
        if b0 >= 0x80:
            ones = 8 - (255 - b0).bit_length() if b0 != 255 else 8
            if ones < 2 or ones > 7:
                raise ValueError("bad frame number coding")
            for _ in range(ones - 1):
                br.bits(8)
        if bs_code == 0 or sr_code == 15 or ss_code == 3:
            raise ValueError("reserved frame header code")
        if bs_code == 1:
            blocksize = 192
        elif bs_code <= 5:
            blocksize = 576 << (bs_code - 2)
        elif bs_code == 6:
            blocksize = br.bits(8) + 1
        elif bs_code == 7:
            blocksize = br.bits(16) + 1
        else:
            blocksize = 256 << (bs_code - 8)
        if sr_code == 12:
            br.bits(8)
        elif sr_code in (13, 14):
            br.bits(16)
        frame_bps = {0: bps, 1: 8, 2: 12, 4: 16, 5: 20, 6: 24, 7: 32}[ss_code]
        br.bits(8)  # header CRC-8
        nch = ca + 1 if ca < 8 else 2
        if ca > 10 or nch != channels:
            raise ValueError("bad channel assignment")
        chs = []
        for c in range(nch):
            sbps = frame_bps + (1 if (ca, c) in ((8, 1), (9, 0), (10, 1)) else 0)
            chs.append(_subframe(br, blocksize, sbps))
        br.align()
        br.bits(16)  # frame CRC-16
        if ca == 8:  # left/side
            chs[1] = [l - s for l, s in zip(chs[0], chs[1])]
        elif ca == 9:  # side/right
            chs[0] = [r + s for s, r in zip(chs[0], chs[1])]
        elif ca == 10:  # mid/side
            left, right = [], []
            for m, s in zip(chs[0], chs[1]):
                m = (m << 1) | (s & 1)
                left.append((m + s) >> 1)
                right.append((m - s) >> 1)
            chs = [left, right]
        out.append(np.asarray(chs, dtype=np.int64).T)
        pos += br.bit >> 3
        if total and sum(o.shape[0] for o in out) >= total:
            break

    samples = np.concatenate(out, axis=0) if out else np.zeros((0, channels), np.int64)
    if total:
        # STREAMINFO promised `total` samples; a stream cut at a frame
        # boundary otherwise decodes clean-but-short (e.g. a partial
        # download of an AudioSet clip would train as silence).
        # Limitation (inherent to FLAC, shared by the C++ decoder in
        # native/wav_core.cpp): when STREAMINFO total_samples == 0
        # ("unknown"), a stream cut exactly at a frame boundary still
        # decodes clean-but-short with no error — callers padding to a
        # fixed clip length should expect short reads for such streams.
        if samples.shape[0] < total:
            raise ValueError(
                f"truncated FLAC stream: decoded {samples.shape[0]} of {total} samples"
            )
        samples = samples[:total]
    data = (samples.astype(np.float64) * norm).astype(np.float32)
    return (data[:, 0] if channels == 1 else data), sr


def decode_flac(path: str) -> Tuple[np.ndarray, int]:
    """FLAC file -> (float32 samples [n] or [n, channels], sample_rate)."""
    with open(path, "rb") as f:
        return decode_flac_bytes(f.read())
