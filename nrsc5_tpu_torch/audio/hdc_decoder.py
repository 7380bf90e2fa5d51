"""HDC (HD-Radio codec, AAC-LC core) bitstream decoder.

Clean-room implementation of the HDC packet syntax established by the
reference's FAAD2 patch (support/faad2-hdc-support.patch):

* ``hdc_data_block`` (patch:755-857): 3-bit block type selects mono/stereo
  (``hdc_is_stereo_layer``, patch:732-753), one shared compact ics header
  (``hdc_data_frame``, patch:630-693: reserved bit, window shape/sequence,
  max_sfb, grouping, ms mask), TNS presence flags up front, then per
  channel the AAC-LC side info (global gain, section data, scalefactors —
  ``side_info`` with scal_flag=1) and spectral data.
* TNS quirk: long windows imply n_filt=1 without reading it
  (patch:920-929).
* An optional trailing fill element (ID_FIL + 1 bit) carries SBR to the
  end of the packet (``hdc_sbr_data_block``, patch:695-730) — decoded by
  audio/sbr.py with the HDC flavor (32 subsamples).

The core layer is standard ISO/IEC 13818-7 / 14496-3 AAC-LC at 22050 Hz,
1024-sample frames (patch:199-212); all spec data tables come from the
generated audio/aac_tables.py.  Output is 2048 stereo samples
at 44100 Hz per packet (reference: include/nrsc5.h:51,56) — via SBR when
present, spectral upsampling otherwise (the ``forceUpSampling`` analog,
patch:210).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from nrsc5_tpu_torch.audio import aac_core as A
from nrsc5_tpu_torch.audio import aac_tables as T
from nrsc5_tpu_torch.audio.bitio import BitReader
from nrsc5_tpu_torch.audio.huffman import PrefixCode

try:  # the native huffman parse (the hot path); pure Python where it fails
    from nrsc5_tpu_torch import native as _native
except Exception:  # pragma: no cover
    _native = None

ID_FIL = 6
LEN_SE_ID = 3

SF_HUFF = PrefixCode(T.FF_AAC_SCALEFACTOR_CODE, T.FF_AAC_SCALEFACTOR_BITS)
SPEC_HUFF = {i: PrefixCode(getattr(T, f"CODES{i}"), getattr(T, f"BITS{i}"))
             for i in range(1, 12)}

STEREO_BLOCK_TYPES = (2, 7)  # patch:732-753
KNOWN_BLOCK_TYPES = (0, 1, 2, 5, 6, 7)


class HDCError(ValueError):
    pass


@dataclass
class IcsInfo:
    window_shape: int = 0
    window_sequence: int = A.ONLY_LONG
    max_sfb: int = 0
    scale_factor_grouping: int = 0
    num_window_groups: int = 1
    group_len: list = field(default_factory=lambda: [1])
    ms_mask_present: int = 0
    ms_used: np.ndarray | None = None
    # per group x sfb
    sfb_cb: np.ndarray | None = None
    scale_factors: np.ndarray | None = None
    global_gain: int = 0
    tns: "TnsInfo | None" = None

    @property
    def short(self) -> bool:
        return self.window_sequence == A.EIGHT_SHORT

    @property
    def num_windows(self) -> int:
        return 8 if self.short else 1

    @property
    def swb_offset(self) -> np.ndarray:
        return A.swb_offsets(self.short)


@dataclass
class TnsInfo:
    n_filt: list = field(default_factory=list)      # per window
    coef_res: list = field(default_factory=list)    # per window
    # per window: list of (length, order, direction, compress, coefs)
    filt: list = field(default_factory=list)


# ----------------------------------------------------------------------
# syntax
# ----------------------------------------------------------------------
def _window_grouping(ics: IcsInfo):
    if ics.short:
        groups, lens = 1, [1]
        for i in range(7):
            if (ics.scale_factor_grouping >> (6 - i)) & 1:
                lens[-1] += 1
            else:
                groups += 1
                lens.append(1)
        ics.num_window_groups, ics.group_len = groups, lens
    else:
        ics.num_window_groups, ics.group_len = 1, [1]
    if ics.max_sfb > A.num_swb(ics.short):
        raise HDCError(f"max_sfb {ics.max_sfb} > num_swb")


def _parse_hdc_data_frame(br: BitReader, stereo: bool) -> IcsInfo:
    """The compact shared ics header (patch:630-693)."""
    ics = IcsInfo()
    if br.read1() != 0:  # ics_reserved_bit
        raise HDCError("ics reserved bit set")
    ics.window_shape = br.read1()
    ics.window_sequence = br.read(2)
    if ics.short:
        ics.max_sfb = br.read(4)
        ics.scale_factor_grouping = br.read(7)
    else:
        ics.max_sfb = br.read(6)
    _window_grouping(ics)
    if stereo:
        ics.ms_mask_present = br.read(2)
        if ics.ms_mask_present == 3:
            raise HDCError("ms_mask_present == 3")
        ics.ms_used = np.zeros((ics.num_window_groups, ics.max_sfb), bool)
        if ics.ms_mask_present == 1:
            for g in range(ics.num_window_groups):
                for sfb in range(ics.max_sfb):
                    ics.ms_used[g, sfb] = bool(br.read1())
        elif ics.ms_mask_present == 2:  # all bands M/S
            ics.ms_used[:] = True
    return ics


def _parse_tns(br: BitReader, ics: IcsInfo) -> TnsInfo:
    """tns_data with the HDC long-window n_filt quirk (patch:916-929)."""
    tns = TnsInfo()
    if ics.short:
        n_filt_bits, length_bits, order_bits = 1, 4, 3
    else:
        n_filt_bits, length_bits, order_bits = 2, 6, 5
    for w in range(ics.num_windows):
        if not ics.short:
            n_filt = 1  # HDC: implicit for long windows
        else:
            n_filt = br.read(n_filt_bits)
        coef_res = 0
        start_coef_bits = 3
        if n_filt:
            coef_res = br.read1()
            if coef_res:
                start_coef_bits = 4
        filts = []
        for _ in range(n_filt):
            length = br.read(length_bits)
            order = br.read(order_bits)
            if order:
                direction = br.read1()
                compress = br.read1()
                coef_bits = start_coef_bits - compress
                coefs = [br.read(coef_bits) for _ in range(order)]
            else:
                direction = compress = 0
                coefs = []
            filts.append((length, order, direction, compress, coefs))
        tns.n_filt.append(n_filt)
        tns.coef_res.append(coef_res)
        tns.filt.append(filts)
    return tns


def _parse_section_data(br: BitReader, ics: IcsInfo):
    sect_bits = 3 if ics.short else 5
    esc = (1 << sect_bits) - 1
    sfb_cb = np.zeros((ics.num_window_groups, ics.max_sfb), np.int32)
    for g in range(ics.num_window_groups):
        k = 0
        while k < ics.max_sfb:
            cb = br.read(4)
            if cb == 12:  # reserved codebook id
                raise HDCError("reserved codebook 12")
            run = 0
            while True:
                incr = br.read(sect_bits)
                run += incr
                if incr != esc:
                    break
            if k + run > ics.max_sfb or br.overrun():
                raise HDCError("section data overrun")
            sfb_cb[g, k:k + run] = cb
            k += run
    ics.sfb_cb = sfb_cb


def _parse_scale_factors(br: BitReader, ics: IcsInfo):
    sf = np.zeros((ics.num_window_groups, ics.max_sfb), np.int32)
    scale_factor = ics.global_gain
    is_position = 0
    noise_energy = ics.global_gain - 90
    noise_pcm = True
    for g in range(ics.num_window_groups):
        for b in range(ics.max_sfb):
            cb = int(ics.sfb_cb[g, b])
            if cb == A.ZERO_HCB:
                sf[g, b] = 0
            elif cb in (A.INTENSITY_HCB, A.INTENSITY_HCB2):
                is_position += SF_HUFF.decode(br) - A.SF_CENTER
                sf[g, b] = is_position
            elif cb == A.NOISE_HCB:
                if noise_pcm:
                    noise_pcm = False
                    noise_energy += br.read(9) - 256
                else:
                    noise_energy += SF_HUFF.decode(br) - A.SF_CENTER
                sf[g, b] = noise_energy
            else:
                scale_factor += SF_HUFF.decode(br) - A.SF_CENTER
                if not 0 <= scale_factor < 256:
                    raise HDCError("scalefactor out of range")
                sf[g, b] = scale_factor
    ics.scale_factors = sf


def _read_escape(br: BitReader) -> int:
    n = 0
    while br.read1() == 1:
        n += 1
        if n > 16 or br.overrun():
            raise HDCError("bad escape")
    return (1 << (n + 4)) | br.read(n + 4)


def _parse_spectral(br: BitReader, ics: IcsInfo) -> np.ndarray:
    """Huffman spectral decode → per-window-ordered coefficients[1024]."""
    offs = ics.swb_offset
    nshort = A.SHORT_LEN
    quant = np.zeros(A.FRAME_LEN, np.int64)
    win_base = 0
    for g in range(ics.num_window_groups):
        glen = ics.group_len[g]
        for b in range(ics.max_sfb):
            cb = int(ics.sfb_cb[g, b])
            width = int(offs[b + 1] - offs[b])
            n = width * glen
            if cb == A.ZERO_HCB or cb >= A.NOISE_HCB:
                continue
            dim, lav, signed = A.CB_META[cb]
            res = _native.hdc_spectral(br.data, br.pos, cb, n) \
                if _native is not None else None
            if res is not None:
                vals, br.pos = res
                vals = vals.astype(np.int64)
            else:
                huff = SPEC_HUFF[cb]
                vals = np.zeros(n, np.int64)
                i = 0
                while i < n:
                    tup = A.unpack_index(cb, huff.decode(br))
                    if not signed:
                        tup = [(-v if v and br.read1() else v) for v in tup]
                    if cb == A.ESC_HCB:
                        tup = [int(np.sign(v)) * _read_escape(br)
                               if abs(v) == 16 else v for v in tup]
                    vals[i:i + dim] = tup[:n - i]
                    i += dim
            if br.overrun():
                raise HDCError("spectral overrun")
            # bitstream order within a group: sfb-major, then window, then
            # bin → scatter to per-window order
            vals = vals.reshape(glen, width)
            for wi in range(glen):
                w = win_base + wi
                lo = w * nshort + int(offs[b]) if ics.short else int(offs[b])
                quant[lo:lo + width] = vals[wi]
        win_base += glen
    return quant


def _parse_ics(br: BitReader, ics: IcsInfo) -> np.ndarray:
    """One channel's individual stream: global gain + section data +
    scale factors + spectral huffman.  The native library parses it in one
    call (``nrsc5_hdc_ics``) where it is built; the Python functions are
    the specification and the path where it is not (the two are pinned
    equal by tests/test_torch_hdc_native.py)."""
    res = None
    if _native is not None:
        try:
            res = _native.hdc_ics(br.data, br.pos, ics.short, ics.max_sfb,
                                  ics.group_len, ics.swb_offset)
        except ValueError as e:
            raise HDCError(str(e)) from None
    if res is not None:
        # the global gain is consumed inside the native call; nothing
        # downstream reads ics.global_gain
        ics.sfb_cb, ics.scale_factors, quant, br.pos = res
        return quant.astype(np.int64)
    ics.global_gain = br.read(8)
    _parse_section_data(br, ics)
    _parse_scale_factors(br, ics)
    return _parse_spectral(br, ics)


# ----------------------------------------------------------------------
# reconstruction
# ----------------------------------------------------------------------
def _band_expand(ics: IcsInfo, vals: np.ndarray) -> np.ndarray:
    """Expand per-(group, band) values to per-bin (FRAME_LEN) layout:
    band b repeats over its swb width, a group's row repeats across its
    windows (short) at window strides of SHORT_LEN."""
    offs = ics.swb_offset
    widths = np.diff(np.asarray(offs[:ics.max_sfb + 1], np.int64))
    out = np.zeros(A.FRAME_LEN, vals.dtype)
    if ics.max_sfb == 0:
        return out
    nb = int(offs[ics.max_sfb])
    if not ics.short:
        out[:nb] = np.repeat(vals[0], widths)
        return out
    o2 = out.reshape(8, A.SHORT_LEN)
    win = 0
    for g in range(ics.num_window_groups):
        o2[win:win + ics.group_len[g], :nb] = np.repeat(vals[g], widths)
        win += ics.group_len[g]
    return out


def _apply_scalefactors(ics: IcsInfo, quant: np.ndarray,
                        rng: np.random.Generator) -> np.ndarray:
    """Dequantize + PNS-fill a whole channel.

    Fully vectorized over bands AND bins (np.repeat band expansion)."""
    spec = np.zeros(A.FRAME_LEN, np.float32)
    if ics.max_sfb == 0:
        return spec
    cb = np.asarray(ics.sfb_cb)
    sf = np.asarray(ics.scale_factors)
    regular = (cb != A.ZERO_HCB) & (cb < A.NOISE_HCB)
    with np.errstate(over="ignore"):
        # both np.where branches evaluate: non-regular bands carry
        # intensity/noise values that may overflow 2^x harmlessly
        gains = np.where(regular, 2.0 ** (0.25 * (sf - A.SF_OFFSET)), 0.0)
    gain_bin = _band_expand(ics, gains)
    nz = gain_bin != 0.0
    if nz.any():
        q = quant[nz].astype(np.float64)
        spec[nz] = (np.sign(q) * np.abs(q) ** (4.0 / 3.0)) * gain_bin[nz]
    if (cb == A.NOISE_HCB).any():
        # PNS: rng draw order must stay (group asc, band asc, window asc)
        # — it is part of the decoder's deterministic output
        offs = ics.swb_offset
        win_base = 0
        for g in range(ics.num_window_groups):
            for b in np.nonzero(cb[g] == A.NOISE_HCB)[0]:
                width = int(offs[b + 1] - offs[b])
                nrg = int(sf[g, b])
                for wi in range(ics.group_len[g]):
                    lo = ((win_base + wi) * A.SHORT_LEN + int(offs[b])) \
                        if ics.short else int(offs[b])
                    # ISO/faad PNS scaling (faad2 pns.c gen_rand_vector):
                    # unit TOTAL band energy then 2^(nrg/4) — per-bin-RMS
                    # is louder by sqrt(width) (caught by the libavcodec
                    # oracle, test_lc_pns_band_energy)
                    noise = rng.standard_normal(width).astype(np.float32)
                    etot = np.sqrt((noise * noise).sum()) or 1.0
                    spec[lo:lo + width] = noise / etot * 2.0 ** (0.25 * nrg)
            win_base += ics.group_len[g]
    return spec


def _apply_ms_is(ics: IcsInfo, ics2: IcsInfo, left: np.ndarray,
                 right: np.ndarray):
    """Mid/side + intensity stereo, vectorized over bins."""
    if ics.max_sfb == 0:
        return
    cb_l = np.asarray(ics.sfb_cb)
    cb_r = np.asarray(ics2.sfb_cb)
    sf_r = np.asarray(ics2.scale_factors)
    ms = np.zeros(cb_r.shape, bool)
    if ics.ms_used is not None:
        w = min(ms.shape[1], ics.ms_used.shape[1])
        ms[:, :w] = ics.ms_used[:, :w]
    intens = (cb_r == A.INTENSITY_HCB) | (cb_r == A.INTENSITY_HCB2)
    invert = (cb_r == A.INTENSITY_HCB2) ^ ms
    with np.errstate(over="ignore"):
        facs = np.where(invert, -1.0, 1.0) * 0.5 ** (0.25 * sf_r)
    i_bin = _band_expand(ics, intens.astype(np.float64)) > 0.5
    if i_bin.any():
        fac_bin = _band_expand(ics, np.where(intens, facs, 0.0))
        right[i_bin] = left[i_bin] * fac_bin[i_bin]
    msb = ms & (cb_r < A.NOISE_HCB) & (cb_l < A.NOISE_HCB)
    m_bin = _band_expand(ics, msb.astype(np.float64)) > 0.5
    if m_bin.any():
        l_ = left[m_bin] + right[m_bin]
        r_ = left[m_bin] - right[m_bin]
        left[m_bin], right[m_bin] = l_, r_


def _tns_lpc(coefs, coef_res, compress):
    """Transmitted TNS indices → direct-form LPC (ISO 14496-3 tns_decode_coef
    via the tmp2 map, tables from aacdec.o).

    The libavcodec tables store NEGATED reflection coefficients (ffmpeg
    compensates with ``r = -coef`` inside compute_lpc_coefs); faad/ISO
    use the positive convention this recursion expects, so negate here.
    Caught by the external libavcodec oracle (test_hdc_external_oracle):
    without it the decoded filter is the spec filter applied to the
    sign-alternated spectrum — a π frequency shift of the TNS band."""
    tab = {(0, 0): T.TNS_TMP2_MAP_0_3, (0, 1): T.TNS_TMP2_MAP_1_3,
           (1, 0): T.TNS_TMP2_MAP_0_4, (1, 1): T.TNS_TMP2_MAP_1_4}[
               (coef_res, compress)]
    tmp2 = [-float(tab[c]) for c in coefs]
    a = np.zeros(len(coefs) + 1)
    a[0] = 1.0
    for m in range(1, len(coefs) + 1):
        b = a.copy()
        for i in range(1, m):
            b[i] = a[i] + tmp2[m - 1] * a[m - i]
        b[m] = tmp2[m - 1]
        a = b
    return a


def _apply_tns(ics: IcsInfo, spec: np.ndarray, decode: bool = True):
    """All-pole (decode) / all-zero (encode) TNS filtering along the
    spectrum (reference behavior: faad tns_decode_frame)."""
    if ics.tns is None:
        return
    offs = ics.swb_offset
    nbands = min(ics.max_sfb, A.tns_max_bands(ics.short))
    size = A.SHORT_LEN if ics.short else A.FRAME_LEN
    for w in range(ics.num_windows):
        # band regions count down from the TOTAL band count (num_swb),
        # then clamp to max_sfb/tns_max_bands — NOT from max_sfb
        # (faad tns_decode_frame: bottom starts at ics->num_swb)
        bottom = A.num_swb(ics.short)
        for (length, order, direction, compress, coefs) in ics.tns.filt[w]:
            top = bottom
            bottom = max(top - length, 0)
            if order == 0:
                continue
            start = int(offs[min(bottom, nbands)])
            end = int(offs[min(top, nbands)])
            if start >= end:
                continue
            a = _tns_lpc(coefs, ics.tns.coef_res[w], compress)
            base = w * size
            s = spec[base:base + size]
            seg = s[start:end] if not direction else s[start:end][::-1]
            # decode: all-pole y[i] = x[i] - Σ a[j]·y[i−j]; encode: the
            # exact inverse all-zero x[i] = y[i] + Σ a[j]·y[i−j] over the
            # ORIGINAL values.  Zero initial state == the reference's
            # break-at-boundary recursion.
            try:
                from scipy.signal import lfilter
                out = lfilter([1.0], a, seg) if decode \
                    else lfilter(a, [1.0], seg)
            except ImportError:  # pure-python fallback (slow, exact)
                out = np.asarray(seg, np.float64).copy()
                if decode:
                    for i in range(len(out)):
                        for j in range(1, min(order, i) + 1):
                            out[i] -= a[j] * out[i - j]
                else:
                    src = np.asarray(seg, np.float64)
                    for i in range(len(out)):
                        for j in range(1, min(order, i) + 1):
                            out[i] += a[j] * src[i - j]
            s[start:end] = out if not direction else out[::-1]


# ----------------------------------------------------------------------
# decoder
# ----------------------------------------------------------------------
class HDCDecoder:
    """Stateful per-program HDC → PCM decoder.

    decode(packet) returns interleaved int16 stereo at 44100 Hz (2048
    samples per channel → 4096 values) or None on a corrupt packet —
    the contract of transport/output.py's decoder factory (reference:
    src/output.c:126-163).
    """

    @staticmethod
    def check():
        return True  # built-in: always available

    def __init__(self):
        self._overlap = [np.zeros(A.FRAME_LEN, np.float32) for _ in range(2)]
        self._prev_shape = [0, 0]
        self._rng = np.random.default_rng(0x48444331)  # PNS source
        from nrsc5_tpu_torch.audio.sbr import SBRDecoder
        self._sbr = [SBRDecoder(), SBRDecoder()]
        self._had_sbr = False

    def reset(self):
        self.__init__()

    # ------------------------------------------------------------------
    def decode(self, packet: bytes) -> np.ndarray | None:
        try:
            return self._decode(packet)
        except Exception:
            # a decoder fed RF-recovered bytes treats every parse problem
            # as a corrupt packet (reference: NeAACDecDecode error return)
            return None

    def decode_float(self, packet: bytes, core: bool = False):
        """Decode to float PCM [n, nch] (no int16 clip, no mono fanout).

        ``core=True`` returns the 22050 Hz AAC-LC core output (1024
        samples) before SBR/upsampling — the comparison point for the
        external AAC-LC oracle (audio/oracle.py). Returns None on a
        corrupt packet."""
        try:
            return self._decode(packet, core=core, as_float=True)
        except Exception:
            return None

    def parse(self, packet: bytes):
        """Host-side front half of the decode: bitstream parse through
        spectral reconstruction (scalefactors, M/S-IS, TNS, PNS) plus
        the SBR payload parse.  Returns (specs, ics1, sbr_data) where
        specs is a list of per-channel float spectra[1024] ready for the
        filterbank — the input contract of audio/batch.py's device
        stage.  Raises on corrupt packets (callers wrap)."""
        return self._parse(bytes(packet))

    def _parse(self, packet: bytes):
        br = BitReader(bytes(packet))
        block_type = br.read(LEN_SE_ID)
        if block_type not in KNOWN_BLOCK_TYPES:
            raise HDCError(f"unknown block type {block_type}")
        stereo = block_type in STEREO_BLOCK_TYPES

        ics1 = _parse_hdc_data_frame(br, stereo)
        ics2 = None
        if stereo:
            ics2 = IcsInfo(**{k: getattr(ics1, k) for k in (
                "window_shape", "window_sequence", "max_sfb",
                "scale_factor_grouping", "num_window_groups",
                "ms_mask_present")})
            ics2.group_len = list(ics1.group_len)
            ics2.ms_used = ics1.ms_used

        # TNS flags precede side info (patch:797-805)
        if br.read1():
            ics1.tns = _parse_tns(br, ics1)
        if stereo and br.read1():
            ics2.tns = _parse_tns(br, ics2)

        # channel 1: side info (scal_flag=1: global gain + sections +
        # scalefactors only) + spectral data.  Each channel's contiguous
        # stream parses in one native call where the library is built.
        q1 = _parse_ics(br, ics1)
        if stereo:
            q2 = _parse_ics(br, ics2)
        if br.overrun():
            raise HDCError("bitstream overrun")

        # optional SBR fill element to end of packet (patch:824-832)
        sbr_payload = None
        if br.bits_left() >= LEN_SE_ID + 1 and \
                br.peek(LEN_SE_ID) == ID_FIL:
            br.skip(LEN_SE_ID)
            if br.read1():
                sbr_payload = br

        left = _apply_scalefactors(ics1, q1, self._rng)
        if stereo:
            right = _apply_scalefactors(ics2, q2, self._rng)
            _apply_ms_is(ics1, ics2, left, right)
        else:
            right = None

        _apply_tns(ics1, left)
        if stereo:
            _apply_tns(ics2, right)

        specs = [left, right] if stereo else [left]
        sbr_data = None
        if sbr_payload is not None:
            from nrsc5_tpu_torch.audio.sbr import parse_sbr_payload
            sbr_data = parse_sbr_payload(sbr_payload, stereo, self._sbr)
        return specs, ics1, sbr_data

    def _decode(self, packet: bytes, core: bool = False,
                as_float: bool = False) -> np.ndarray:
        specs, ics1, sbr_data = self._parse(packet)
        stereo = len(specs) == 2

        chans = []
        for i, spec in enumerate(specs):
            pcm_i, self._overlap[i] = A.filterbank_synthesis(
                spec, ics1.window_sequence, ics1.window_shape,
                self._prev_shape[i], self._overlap[i])
            chans.append(pcm_i)
            self._prev_shape[i] = ics1.window_shape

        if core:
            return np.stack(chans, axis=-1).astype(np.float32)

        # SBR / upsampling to 44100 (2048 samples per channel)
        if sbr_data is not None:
            self._had_sbr = True
            out = [self._sbr[i].process(chans[i], sbr_data[i])
                   for i in range(len(chans))]
        else:
            out = [self._sbr[i].upsample_only(chans[i])
                   for i in range(len(chans))]

        if as_float:
            return np.stack(out, axis=-1).astype(np.float32)
        if len(out) == 1:
            out = [out[0], out[0]]  # mono → both channels
        # internal full-scale is ±32768 (see tx/hdc_encoder.py)
        pcm = np.stack(out, axis=-1).reshape(-1)
        return np.clip(np.round(pcm), -32768, 32767).astype(np.int16)
