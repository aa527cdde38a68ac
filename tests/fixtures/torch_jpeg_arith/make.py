"""Arithmetic-coded JPEG streams (ITU T.81 Annex D, libjpeg's
``jcarith.c``) and the fixtures of ``unmicst_tpu_torch/io/jpeg.py``'s
arithmetic decode.

    python tests/fixtures/torch_jpeg_arith/make.py

The encoder (:func:`encode`) takes DCT coefficients, int16 ``[blocks,
64]`` in natural order, each component's block grid padded to whole MCUs
(as ``unmicst_tpu_torch.io.jpeg.decode_coefficients`` returns them, or
as :func:`random_coefficients` makes them), and writes a SOF9
(sequential) or SOF10 (progressive) stream: the QM coder of
``jcarith.c`` with its statistics areas, DC and AC conditioning (a DAC
segment where asked), restart intervals and successive approximation.
:func:`random_entropy` writes a stream whose entropy-coded data are
random bytes (0xFF stuffed), which libjpeg's decoder reads as one image.
Nothing here imports the package under test, nor PIL but :func:`main`.

:func:`main` needs PIL and writes, beside this script, each case of
:func:`cases` (seeded streams at 1x1 to 40x33: gray and colour at h1v1,
h2v1 and h2v2, sequential and progressive with spectral selection and
successive approximation, restart intervals, non-default DAC values and
tables, one scan per component, random entropy-coded data, data cut
short before EOI (in the last scan, so that every coefficient's
precision is final and libjpeg does not smooth the blocks),
coefficients far outside an image's range) as
``<case>.jpg`` and PIL's ``np.asarray`` of it as ``<case>.npy``.

The card's machine has no PIL, so ``chip_smoke.py`` compares the port
with these files.
"""

import os
import struct

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# jaricom.c's Table D.2: (Qe, Next_Index_LPS, Next_Index_MPS, Switch_MPS),
# and a last entry for the fixed bin (probability 0.5, no adaptation)
_TABLE_D2 = (
    (0x5a1d, 1, 1, 1), (0x2586, 14, 2, 0), (0x1114, 16, 3, 0),
    (0x080b, 18, 4, 0), (0x03d8, 20, 5, 0), (0x01da, 23, 6, 0),
    (0x00e5, 25, 7, 0), (0x006f, 28, 8, 0), (0x0036, 30, 9, 0),
    (0x001a, 33, 10, 0), (0x000d, 35, 11, 0), (0x0006, 9, 12, 0),
    (0x0003, 10, 13, 0), (0x0001, 12, 13, 0), (0x5a7f, 15, 15, 1),
    (0x3f25, 36, 16, 0), (0x2cf2, 38, 17, 0), (0x207c, 39, 18, 0),
    (0x17b9, 40, 19, 0), (0x1182, 42, 20, 0), (0x0cef, 43, 21, 0),
    (0x09a1, 45, 22, 0), (0x072f, 46, 23, 0), (0x055c, 48, 24, 0),
    (0x0406, 49, 25, 0), (0x0303, 51, 26, 0), (0x0240, 52, 27, 0),
    (0x01b1, 54, 28, 0), (0x0144, 56, 29, 0), (0x00f5, 57, 30, 0),
    (0x00b7, 59, 31, 0), (0x008a, 60, 32, 0), (0x0068, 62, 33, 0),
    (0x004e, 63, 34, 0), (0x003b, 32, 35, 0), (0x002c, 33, 9, 0),
    (0x5ae1, 37, 37, 1), (0x484c, 64, 38, 0), (0x3a0d, 65, 39, 0),
    (0x2ef1, 67, 40, 0), (0x261f, 68, 41, 0), (0x1f33, 69, 42, 0),
    (0x19a8, 70, 43, 0), (0x1518, 72, 44, 0), (0x1177, 73, 45, 0),
    (0x0e74, 74, 46, 0), (0x0bfb, 75, 47, 0), (0x09f8, 77, 48, 0),
    (0x0861, 78, 49, 0), (0x0706, 79, 50, 0), (0x05cd, 48, 51, 0),
    (0x04de, 50, 52, 0), (0x040f, 50, 53, 0), (0x0363, 51, 54, 0),
    (0x02d4, 52, 55, 0), (0x025c, 53, 56, 0), (0x01f8, 54, 57, 0),
    (0x01a4, 55, 58, 0), (0x0160, 56, 59, 0), (0x0125, 57, 60, 0),
    (0x00f6, 58, 61, 0), (0x00cb, 59, 62, 0), (0x00ab, 61, 63, 0),
    (0x008f, 61, 32, 0), (0x5b12, 65, 65, 1), (0x4d04, 80, 66, 0),
    (0x412c, 81, 67, 0), (0x37d8, 82, 68, 0), (0x2fe8, 83, 69, 0),
    (0x293c, 84, 70, 0), (0x2379, 86, 71, 0), (0x1edf, 87, 72, 0),
    (0x1aa9, 87, 73, 0), (0x174e, 72, 74, 0), (0x1424, 72, 75, 0),
    (0x119c, 74, 76, 0), (0x0f6b, 74, 77, 0), (0x0d51, 75, 78, 0),
    (0x0bb6, 77, 79, 0), (0x0a40, 77, 48, 0), (0x5832, 80, 81, 1),
    (0x4d1c, 88, 82, 0), (0x438e, 89, 83, 0), (0x3bdd, 90, 84, 0),
    (0x34ee, 91, 85, 0), (0x2eae, 92, 86, 0), (0x299a, 93, 87, 0),
    (0x2516, 86, 71, 0), (0x5570, 88, 89, 1), (0x4ca9, 95, 90, 0),
    (0x44d9, 96, 91, 0), (0x3e22, 97, 92, 0), (0x3824, 99, 93, 0),
    (0x32b4, 99, 94, 0), (0x2e17, 93, 86, 0), (0x56a8, 95, 96, 1),
    (0x4f46, 101, 97, 0), (0x47e5, 102, 98, 0), (0x41cf, 103, 99, 0),
    (0x3c3d, 104, 100, 0), (0x375e, 99, 93, 0), (0x5231, 105, 102, 0),
    (0x4c0f, 106, 103, 0), (0x4639, 107, 104, 0), (0x415e, 103, 99, 0),
    (0x5627, 105, 106, 1), (0x50e7, 108, 107, 0), (0x4b85, 109, 103, 0),
    (0x5597, 110, 109, 0), (0x504f, 111, 107, 0), (0x5a10, 110, 111, 1),
    (0x5522, 112, 109, 0), (0x59eb, 112, 111, 1), (0x5a1d, 113, 113, 0),
)
# jaricom.c's packed form: Qe << 16 | Next_Index_MPS << 8 | Switch_MPS << 7
# | Next_Index_LPS
ARITAB = tuple((qe << 16) | (nm << 8) | (sw << 7) | nl
               for qe, nl, nm, sw in _TABLE_D2)

NATURAL_ORDER = (
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63)


class QMEncoder:
    """``jcarith.c``'s ``arith_encode`` and ``finish_pass`` (sections
    D.1.4-D.1.8): the C and A registers, the stacked 0xFF and pending
    0x00 counts, byte stuffing and the "Pacman" termination."""

    def __init__(self, out: bytearray):
        self.out = out
        self.reset()

    def reset(self):
        self.c, self.a, self.sc, self.zc, self.ct, self.buffer = (
            0, 0x10000, 0, 0, 11, -1)

    def _emit(self, b: int):
        self.out.append(b)
        if b == 0xFF:
            self.out.append(0)

    def _flush_zeros(self):
        while self.zc:
            self.out.append(0)
            self.zc -= 1

    def encode(self, st, i: int, val: int):
        sv = st[i]
        t = ARITAB[sv & 0x7F]
        nl, nm, qe = t & 0xFF, (t >> 8) & 0xFF, t >> 16
        a = self.a - qe
        if val != (sv >> 7):
            if a >= qe:
                self.c += a
                a = qe
            st[i] = (sv & 0x80) ^ nl
        else:
            if a >= 0x8000:
                self.a = a
                return
            if a < qe:
                self.c += a
                a = qe
            st[i] = (sv & 0x80) ^ nm
        c, ct = self.c, self.ct
        while True:
            a <<= 1
            c <<= 1
            ct -= 1
            if ct == 0:
                temp = c >> 19
                if temp > 0xFF:
                    if self.buffer >= 0:
                        self._flush_zeros()
                        self._emit(self.buffer + 1)
                    self.zc += self.sc
                    self.sc = 0
                    self.buffer = temp & 0xFF
                elif temp == 0xFF:
                    self.sc += 1
                else:
                    if self.buffer == 0:
                        self.zc += 1
                    elif self.buffer >= 0:
                        self._flush_zeros()
                        self._emit(self.buffer)
                    if self.sc:
                        self._flush_zeros()
                        self.out += b"\xff\x00" * self.sc
                        self.sc = 0
                    self.buffer = temp & 0xFF
                c &= 0x7FFFF
                ct += 8
            if a >= 0x8000:
                break
        self.a, self.c, self.ct = a, c, ct

    def finish(self):
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        if self.c & 0xF8000000:
            if self.buffer >= 0:
                self._flush_zeros()
                self._emit(self.buffer + 1)
            self.zc += self.sc
            self.sc = 0
        else:
            if self.buffer == 0:
                self.zc += 1
            elif self.buffer >= 0:
                self._flush_zeros()
                self._emit(self.buffer)
            if self.sc:
                self._flush_zeros()
                self.out += b"\xff\x00" * self.sc
                self.sc = 0
        if self.c & 0x7FFF800:
            self._flush_zeros()
            self._emit((self.c >> 19) & 0xFF)
            if self.c & 0x7F800:
                self._emit((self.c >> 11) & 0xFF)


def _encode_value(enc, st, base, v, mag_bins, k_ac=None):
    """Figures F.6-F.9 past the sign: the magnitude category of ``v - 1``
    (``v`` > 0) and its bits.  ``base`` is the bin after the sign;
    ``mag_bins`` the X1 bin of DC (an int) or, for AC (``k_ac`` given),
    the pair (189, 217) chosen by Kx."""
    enc_ = enc.encode
    m = 0
    v -= 1
    if v:
        enc_(st, base, 1)
        m = 1
        v2 = v
        if k_ac is None:
            base = mag_bins
            v2 >>= 1
            while v2:
                enc_(st, base, 1)
                m <<= 1
                base += 1
                v2 >>= 1
        else:
            v2 >>= 1
            if v2:
                enc_(st, base, 1)
                m <<= 1
                base = mag_bins
                v2 >>= 1
                while v2:
                    enc_(st, base, 1)
                    m <<= 1
                    base += 1
                    v2 >>= 1
    enc_(st, base, 0)
    base += 14
    m >>= 1
    while m:
        enc_(st, base, 1 if m & v else 0)
        m >>= 1


class _Scan:
    def __init__(self, enc, n_comps, dc_l, dc_u, ac_k, tds, tas):
        self.enc = enc
        self.dc_stats = {t: [0] * 64 for t in set(tds)}
        self.ac_stats = {t: [0] * 256 for t in set(tas)}
        self.fixed = [113]
        self.last_dc = [0] * n_comps
        self.ctx = [0] * n_comps
        self.dc_l, self.dc_u, self.ac_k = dc_l, dc_u, ac_k
        self.tds, self.tas = tds, tas

    def restart(self, dc: bool, ac: bool):
        for t in self.dc_stats if dc else ():
            self.dc_stats[t][:] = [0] * 64
        for t in self.ac_stats if ac else ():
            self.ac_stats[t][:] = [0] * 256
        if dc:
            self.last_dc = [0] * len(self.last_dc)
            self.ctx = [0] * len(self.ctx)

    def dc(self, ci: int, value: int):
        """Figure F.4 (and F.6-F.9) for one DC value of scan component
        ``ci``, with F.1.4.4.1.2's conditioning."""
        enc, t = self.enc, self.tds[ci]
        st = self.dc_stats[t]
        s0 = self.ctx[ci]
        v = value - self.last_dc[ci]
        if v == 0:
            enc.encode(st, s0, 0)
            self.ctx[ci] = 0
            return
        self.last_dc[ci] = value
        enc.encode(st, s0, 1)
        if v > 0:
            enc.encode(st, s0 + 1, 0)
            base, ctx = s0 + 2, 4
        else:
            v = -v
            enc.encode(st, s0 + 1, 1)
            base, ctx = s0 + 3, 8
        m = 0 if v == 1 else 1 << ((v - 1).bit_length() - 1)
        _encode_value(enc, st, base, v, 20)
        if m < (1 << self.dc_l[t]) >> 1:
            ctx = 0
        elif m > (1 << self.dc_u[t]) >> 1:
            ctx += 8
        self.ctx[ci] = ctx

    def ac(self, ci: int, vals, ss: int, ke: int, se: int):
        """Figure F.5 over coefficients ``ss..se`` of one block, ``vals``
        (zigzag order, already shifted) ending at ``ke``."""
        enc, t = self.enc, self.tas[ci]
        st = self.ac_stats[t]
        k = ss
        while k <= ke:
            b = 3 * (k - 1)
            enc.encode(st, b, 0)
            while vals[k] == 0:
                enc.encode(st, b + 1, 0)
                b += 3
                k += 1
            enc.encode(st, b + 1, 1)
            v = vals[k]
            enc.encode(self.fixed, 0, 0 if v > 0 else 1)
            _encode_value(enc, st, b + 2, abs(v),
                          189 if k <= self.ac_k[t] else 217, k)
            k += 1
        if k <= se:
            enc.encode(st, 3 * (k - 1), 1)


def _shift_toward_zero(v: int, n: int) -> int:
    return v >> n if v >= 0 else -((-v) >> n)


def scan_order(comps, height, width, scan_comps):
    """The blocks of a scan: ``(per_mcu, [(block, scan component)])``,
    blocks numbered as in the coefficient array (each component's grid
    padded to whole MCUs, one after another)."""
    hmax = max(c[1] for c in comps)
    vmax = max(c[2] for c in comps)
    mr, mc = -(-height // (8 * vmax)), -(-width // (8 * hmax))
    offs = [0]
    for _, h, v, _ in comps:
        offs.append(offs[-1] + mr * v * mc * h)
    if len(scan_comps) == 1:
        i = scan_comps[0]
        _, h, v, _ = comps[i]
        rows = -(-(-(-height * v // vmax)) // 8)
        cols = -(-(-(-width * h // hmax)) // 8)
        return 1, [(offs[i] + r * mc * h + c, 0)
                   for r in range(rows) for c in range(cols)]
    out = []
    for my in range(mr):
        for mx in range(mc):
            for k, i in enumerate(scan_comps):
                _, h, v, _ = comps[i]
                for y in range(v):
                    for x in range(h):
                        out.append((offs[i] + (my * v + y) * mc * h
                                    + mx * h + x, k))
    return sum(comps[i][1] * comps[i][2] for i in scan_comps), out


def _segment(marker: int, body: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body


def headers(comps, height, width, qtables, restart=0, dac=None,
            progressive=False, app=b""):
    """SOI, ``app``, the DQT segments, SOF9 or SOF10, DAC and DRI:
    ``(bytes, (dc_l, dc_u, ac_k))``, the conditioning of each of the 16
    tables (T.81's defaults L 0, U 1, Kx 5 where ``dac`` names none)."""
    dc_l, dc_u, ac_k = [0] * 16, [1] * 16, [5] * 16
    out = bytearray(b"\xff\xd8") + app
    for slot, q in sorted(qtables.items()):
        q = np.asarray(q).reshape(64)[list(NATURAL_ORDER)]
        if q.max() > 255:
            out += _segment(0xDB, bytes([0x10 | slot]) + q.astype(
                ">u2").tobytes())
        else:
            out += _segment(0xDB, bytes([slot]) + q.astype(
                np.uint8).tobytes())
    out += _segment(0xCA if progressive else 0xC9, struct.pack(
        ">BHHB", 8, height, width, len(comps)) + b"".join(
        bytes([cid, (h << 4) | v, tq]) for cid, h, v, tq in comps))
    if dac:
        body = b""
        for t, (lo, up) in sorted(dac.get("dc", {}).items()):
            dc_l[t], dc_u[t] = lo, up
            body += bytes([t, (up << 4) | lo])
        for t, kx in sorted(dac.get("ac", {}).items()):
            ac_k[t] = kx
            body += bytes([16 + t, kx])
        out += _segment(0xCC, body)
    if restart:
        out += _segment(0xDD, struct.pack(">H", restart))
    return bytes(out), (dc_l, dc_u, ac_k)


def sos(comps, sc) -> bytes:
    """The SOS segment of scan ``sc`` (a dict as :func:`encode` takes)."""
    return _segment(0xDA, bytes([len(sc["comps"])]) + b"".join(
        bytes([comps[i][0], (sc["td"][k] << 4) | sc["ta"][k]])
        for k, i in enumerate(sc["comps"])) + bytes(
        [sc["ss"], sc["se"], (sc["ah"] << 4) | sc["al"]]))


def _default_scans(comps):
    return [dict(comps=list(range(len(comps))), td=[0] * len(comps),
                 ta=[0] * len(comps), ss=0, se=63, ah=0, al=0)]


def encode(coef, comps, height, width, qtables, scans=None, restart=0,
           dac=None, progressive=False, app=b""):
    """An arithmetic-coded JPEG of ``coef`` (int16 ``[blocks, 64]``,
    natural order): ``comps`` are ``(id, h, v, quantisation slot)``,
    ``qtables`` slot -> 64 quantisers in natural order.  ``scans``: dicts
    with ``comps`` (frame component indices), ``td`` / ``ta`` (the
    conditioning table of each, 0-15), ``ss``, ``se``, ``ah``, ``al``;
    by default one interleaved sequential scan, tables 0.  ``restart``:
    MCUs per restart interval.  ``dac``: ``{"dc": {t: (L, U)}, "ac": {t:
    Kx}}`` written as a DAC segment.  ``app``: marker segments written
    after SOI."""
    coef = np.asarray(coef)
    zz = coef[:, list(NATURAL_ORDER)].astype(np.int64).tolist()
    head, cond = headers(comps, height, width, qtables, restart, dac,
                         progressive, app)
    out = bytearray(head)
    for sc in scans or _default_scans(comps):
        out += sos(comps, sc)
        _encode_scan(out, zz, comps, height, width, sc, restart, *cond,
                     progressive)
    return bytes(out + b"\xff\xd9")


def _encode_scan(out, zz, comps, height, width, sc, restart, dc_l, dc_u,
                 ac_k, progressive):
    ss, se, ah, al = sc["ss"], sc["se"], sc["ah"], sc["al"]
    if not progressive:
        ss, se, ah, al = 0, 63, 0, 0
    per_mcu, blocks = scan_order(comps, height, width, sc["comps"])
    enc = QMEncoder(out)
    s = _Scan(enc, len(sc["comps"]), dc_l, dc_u, ac_k, sc["td"], sc["ta"])
    dc_first = ss == 0 and ah == 0
    n_mcus = len(blocks) // per_mcu
    rst = 0
    for mcu in range(n_mcus):
        if restart and mcu and mcu % restart == 0:
            enc.finish()
            out += bytes([0xFF, 0xD0 + rst])
            rst = (rst + 1) & 7
            s.restart(dc=not progressive or dc_first,
                      ac=not progressive or se > 0)
            enc.reset()
        for b, ci in blocks[mcu * per_mcu:(mcu + 1) * per_mcu]:
            vals = zz[b]
            if not progressive:
                s.dc(ci, vals[0])
                ke = 63
                while ke and not vals[ke]:
                    ke -= 1
                s.ac(ci, vals, 1, ke, 63)
            elif ss == 0 and ah == 0:  # DC first: the DC >> Al
                s.dc(ci, vals[0] >> al)
            elif ss == 0:  # DC refine: bit Al, fixed probability
                enc.encode(s.fixed, 0, (vals[0] >> al) & 1)
            elif ah == 0:  # AC first
                sv = [0] * ss + [_shift_toward_zero(x, al)
                                 for x in vals[ss:se + 1]]
                ke = se
                while ke >= ss and not sv[ke]:
                    ke -= 1
                s.ac(ci, sv, ss, max(ke, ss - 1), se)
            else:
                _ac_refine(s, ci, vals, ss, se, ah, al)
    enc.finish()


def _ac_refine(s, ci, vals, ss, se, ah, al):
    """Figure G.10 (``jcarith.c``'s ``encode_mcu_AC_refine``)."""
    enc, st = s.enc, s.ac_stats[s.tas[ci]]
    ke = se
    while ke > 0 and not abs(vals[ke]) >> al:
        ke -= 1
    kex = ke
    while kex > 0 and not abs(vals[kex]) >> ah:
        kex -= 1
    k = ss
    while k <= ke:
        b = 3 * (k - 1)
        if k > kex:
            enc.encode(st, b, 0)
        while True:
            v = vals[k]
            a = abs(v) >> al
            if a:
                if a >> 1:
                    enc.encode(st, b + 2, a & 1)
                else:
                    enc.encode(st, b + 1, 1)
                    enc.encode(s.fixed, 0, 0 if v >= 0 else 1)
                break
            enc.encode(st, b + 1, 0)
            b += 3
            k += 1
        k += 1
    if k <= se:
        enc.encode(st, 3 * (k - 1), 1)


def random_entropy(rng, comps, height, width, qtables, scans=None,
                   restart=0, n_bytes=64, progressive=False, dac=None):
    """A stream with :func:`encode`'s headers whose entropy-coded data
    (each restart interval's) are ``n_bytes`` random bytes, 0xFF
    stuffed."""
    head, _ = headers(comps, height, width, qtables, restart, dac,
                      progressive)
    out = bytearray(head)
    for sc in scans or _default_scans(comps):
        out += sos(comps, sc)
        per_mcu, blocks = scan_order(comps, height, width, sc["comps"])
        n_mcus = len(blocks) // per_mcu
        intervals = -(-n_mcus // restart) if restart else 1
        for k in range(intervals):
            if k:
                out += bytes([0xFF, 0xD0 + (k - 1) % 8])
            out += rng.randint(0, 256, n_bytes).astype(
                np.uint8).tobytes().replace(b"\xff", b"\xff\x00")
    return bytes(out + b"\xff\xd9")


# a luma-like and a chroma-like quantisation table, natural order
QTABLES = {
    0: np.clip(np.add.outer(np.arange(8), np.arange(8)) * 3 + 4, 1, 255),
    1: np.clip(np.add.outer(np.arange(8), np.arange(8)) * 5 + 9, 1, 255),
}
# colour components: (id, h, v, quantisation slot) at each sampling
SAMPLINGS = {
    "gray": [(1, 1, 1, 0)],
    "h1v1": [(1, 1, 1, 0), (2, 1, 1, 1), (3, 1, 1, 1)],
    "h2v1": [(1, 2, 1, 0), (2, 1, 1, 1), (3, 1, 1, 1)],
    "h2v2": [(1, 2, 2, 0), (2, 1, 1, 1), (3, 1, 1, 1)],
}


def n_blocks(comps, height, width) -> int:
    """The coefficient blocks of a frame: each component's grid, padded
    to whole MCUs."""
    hmax = max(c[1] for c in comps)
    vmax = max(c[2] for c in comps)
    mr, mc = -(-height // (8 * vmax)), -(-width // (8 * hmax))
    return sum(mr * v * mc * h for _, h, v, _ in comps)


def random_coefficients(rng, comps, height, width, peak=600):
    """Seeded coefficients shaped like an image's: DC levels wandering
    around 0, AC terms sparse and falling off with frequency."""
    n = n_blocks(comps, height, width)
    coef = np.zeros((n, 64), np.int64)
    coef[:, 0] = np.cumsum(rng.randint(-9, 10, n)) % 120 - 60
    zz = np.arange(1, 64)
    keep = rng.rand(n, 63) < 0.6 / (1 + zz / 6)
    mag = rng.randint(1, peak, (n, 63)) // (1 + zz)
    coef[:, list(NATURAL_ORDER[1:])] = np.where(
        keep, np.where(rng.rand(n, 63) < 0.5, -1, 1) * np.maximum(mag, 1), 0)
    return coef.astype(np.int16)


def progressive_scans(n: int, tables=(0, 1)):
    """A successive-approximation script (libjpeg's
    ``jpeg_simple_progression`` for gray or YCbCr): DC first at Al 1, AC
    1-5 and 6-63 at Al 2, AC refine to Al 1, DC refine, AC refine to 0;
    component 0 on table ``tables[0]``, the others on ``tables[1]``."""
    t = [tables[0]] + [tables[1]] * (n - 1)
    every = list(range(n))
    out = [dict(comps=every, td=t, ta=t, ss=0, se=0, ah=0, al=1)]
    for ss, se, ah, al in ((1, 5, 0, 2), (6, 63, 0, 2), (1, 63, 2, 1)):
        out += [dict(comps=[i], td=[t[i]], ta=[t[i]], ss=ss, se=se, ah=ah,
                     al=al) for i in every]
    out.append(dict(comps=every, td=t, ta=t, ss=0, se=0, ah=1, al=0))
    out += [dict(comps=[i], td=[t[i]], ta=[t[i]], ss=1, se=63, ah=1, al=0)
            for i in every]
    return out


def sequential_scans(n: int, tables=(0, 1), interleaved=True):
    """One interleaved scan, or one scan per component."""
    t = [tables[0]] + [tables[1]] * (n - 1)
    if interleaved:
        return [dict(comps=list(range(n)), td=t, ta=t, ss=0, se=63, ah=0,
                     al=0)]
    return [dict(comps=[i], td=[t[i]], ta=[t[i]], ss=0, se=63, ah=0, al=0)
            for i in range(n)]


def cut_before_eoi(stream: bytes, keep: float) -> bytes:
    """``stream`` with its last scan's entropy-coded data cut at ``keep``
    of their length, then EOI: libjpeg reads zeros past the cut."""
    sos = stream.rindex(b"\xff\xda")
    start = sos + 2 + struct.unpack(">H", stream[sos + 2:sos + 4])[0]
    cut = start + int((len(stream) - 2 - start) * keep)
    while stream[cut - 1] == 0xFF:
        cut -= 1
    return stream[:cut] + b"\xff\xd9"


def case(name: str, height: int, width: int, sampling: str = "gray",
         progressive: bool = False, restart: int = 0, dac=None,
         tables=(0, 1), interleaved=True, random_bytes: int = 0,
         cut: float = 0.0, peak: int = 600, seed: int = 0) -> bytes:
    """One seeded arithmetic-coded stream (see :func:`cases`)."""
    rng = np.random.RandomState(seed + sum(name.encode()))
    comps = SAMPLINGS[sampling]
    n = len(comps)
    scans = (progressive_scans(n, tables) if progressive
             else sequential_scans(n, tables, interleaved))
    q = {0: QTABLES[0], 1: QTABLES[1]} if n > 1 else {0: QTABLES[0]}
    if random_bytes:
        return random_entropy(rng, comps, height, width, q, scans, restart,
                              random_bytes, progressive, dac)
    data = encode(random_coefficients(rng, comps, height, width, peak),
                  comps, height, width, q, scans, restart, dac, progressive)
    return cut_before_eoi(data, cut) if cut else data


CASES = {
    "seq_gray_1x1": dict(height=1, width=1),
    "seq_gray_13x17": dict(height=13, width=17),
    "seq_h1v1_40x33": dict(height=40, width=33, sampling="h1v1"),
    "seq_h2v1_40x33": dict(height=40, width=33, sampling="h2v1"),
    "seq_h2v2_40x33": dict(height=40, width=33, sampling="h2v2"),
    "seq_gray_restart2_dac": dict(height=24, width=40, restart=2, dac={
        "dc": {0: (2, 6)}, "ac": {0: 20}}),
    "seq_h2v2_restart1_dac": dict(height=33, width=40, sampling="h2v2",
                                  restart=1, dac={"dc": {0: (0, 0),
                                                         1: (3, 4)},
                                                  "ac": {0: 1, 1: 63}}),
    "seq_h2v1_scan_per_component": dict(height=19, width=27,
                                        sampling="h2v1", interleaved=False),
    "seq_h1v1_tables_5_9": dict(height=16, width=16, sampling="h1v1",
                                tables=(5, 9), dac={"dc": {9: (1, 2)},
                                                    "ac": {5: 3}}),
    "prog_gray_13x17": dict(height=13, width=17, progressive=True),
    "prog_h2v2_40x33": dict(height=40, width=33, sampling="h2v2",
                            progressive=True),
    "prog_h2v1_restart3_dac": dict(height=29, width=35, sampling="h2v1",
                                   progressive=True, restart=3,
                                   dac={"dc": {0: (1, 3)},
                                        "ac": {0: 2, 1: 40}}),
    "random_seq_gray": dict(height=13, width=17, random_bytes=48),
    "random_seq_h2v2_restart2": dict(height=40, width=33, sampling="h2v2",
                                     restart=2, random_bytes=24),
    "random_prog_gray": dict(height=24, width=24, progressive=True,
                             random_bytes=16),
    "random_prog_h2v2_restart1": dict(height=33, width=40, sampling="h2v2",
                                      progressive=True, restart=1,
                                      random_bytes=8),
    "cut_seq_h2v2": dict(height=40, width=33, sampling="h2v2", cut=0.5),
    "cut_prog_gray_restart2": dict(height=32, width=32, progressive=True,
                                   restart=2, cut=0.3),
    "cut_seq_h2v1_scan_per_component": dict(height=19, width=27,
                                            sampling="h2v1",
                                            interleaved=False, cut=0.1),
    "extreme_coefficients": dict(height=16, width=48, peak=65535),
}


def cases():
    """name -> stream of every fixture."""
    return {name: case(name, **kw) for name, kw in CASES.items()}


def main() -> None:
    import io

    from PIL import Image

    for name, data in cases().items():
        with Image.open(io.BytesIO(data)) as im:
            px = np.asarray(im)
        with open(os.path.join(HERE, name + ".jpg"), "wb") as f:
            f.write(data)
        np.save(os.path.join(HERE, name + ".npy"), px)


if __name__ == "__main__":
    main()
