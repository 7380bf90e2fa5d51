"""HDC encoder — truth-harness counterpart of audio/hdc_decoder.

Produces valid HDC packets (the bitstream syntax of
support/faad2-hdc-support.patch: hdc_data_block / hdc_data_frame element
layout, AAC-LC core at 22050 Hz) from 44100 Hz PCM, so session/CLI tests
can assert real decoded AUDIO events end-to-end.  The reference ships no
encoder — broadcast HDC packets are produced by commercial exciters — so,
as with the L1/L2 modulator in tx/, this encoder exists to generate
self-consistent test vectors: decode(encode(pcm)) ≈ pcm.

Tools emitted (each optional per constructor flags, every combination a
legal HDC stream): all four window sequences (EIGHT_SHORT on detected
transients with proper LONG_START/LONG_STOP transitions, one group of 8
short windows; sine shape), per-sfb scalefactors, spectral codebooks
{0,2,6,8,10,11} + NOISE/INTENSITY, mid/side stereo, intensity stereo,
PNS noise substitution, TNS, and the SBR fill element.  Tool-interaction
rules mirror the decoder's inversion order: TNS is analyzed/applied on
L/R before the M/S transform, PNS is withheld inside M/S frames, and
intensity is withheld on TNS frames (see the inline comments).

Window-sequence decisions need one frame of lookahead (a transient in
frame n requires frame n-1 to end with a short slope, i.e. LONG_START),
so the encoder carries one pending frame: packet k carries input frame
k-1, with a silent frame seeding the pipeline.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from nrsc5_tpu_torch.audio import aac_core as A
from nrsc5_tpu_torch.audio import aac_tables as TBL
from nrsc5_tpu_torch.audio.bitio import BitWriter
from nrsc5_tpu_torch.audio.hdc_decoder import (ID_FIL, LEN_SE_ID, SF_HUFF,
                                         SPEC_HUFF, IcsInfo, TnsInfo,
                                         _apply_tns)


@dataclass
class _ChPlan:
    """One channel's fully-quantized frame (serializer input)."""
    cbs: np.ndarray          # [max_sfb] codebook per band
    sfs: np.ndarray          # [max_sfb] scalefactor / position / energy
    quants: list             # per-band quantized coefficients
    global_gain: int
    tns_idxs: list | None    # 4-bit TNS reflection-coef indices, or None


@dataclass
class _FramePlan:
    """Container-independent encoded frame: everything both the HDC and
    the standard-AAC (ADTS) serializers need.  Separating the plan from
    the bit writing lets the external-oracle tests emit the SAME spectral
    content as a standard AAC-LC / HE-AAC stream for libavcodec."""
    seq: int
    max_sfb: int
    use_ms: bool
    chans: list              # [_ChPlan] per channel
    env_rows: list | None    # SBR envelope rows per channel (None: no SBR)
    sbr_grid: dict | None = None  # transient grid (None: FIXFIX 1 env)

    @property
    def short(self) -> bool:
        return self.seq == A.EIGHT_SHORT

# smallest codebook fully covering a given max |q| (unsigned books need
# sign bits; the signed 4-dim book 2 wins at LAV 1)
_BOOK_BY_MAX = [(1, 2), (4, 6), (7, 8), (12, 10)]
TARGET_MAXQ = 42  # per-band quantization target (≈ 33 dB band SNR)


def _halfband(n_taps: int = 94) -> np.ndarray:
    """Windowed-sinc lowpass at fs/4 for the 44.1k→22.05k decimation.

    Even length on purpose: its half-sample delay cancels the QMF pair's,
    so the whole codec has an integer group delay (≈ 2673 samples)."""
    n = np.arange(n_taps) - (n_taps - 1) / 2
    h = np.sinc(n / 2.0) / 2.0 * np.hamming(n_taps)
    return (h / h.sum()).astype(np.float64)


class HDCEncoder:
    """Streaming PCM → HDC packets (one packet per 2048 input samples).

    ``target_maxq`` trades rate for quality (peak quantized magnitude per
    band); ``floor_db`` drops bands that far below the frame peak.
    ``sbr`` appends an SBR fill element restoring the 11-22 kHz band
    (single-envelope FIXFIX grid, band energies measured from the input
    through a 64-band QMF; reference syntax: faad2-hdc-support patch
    hdc_sbr_data_block)."""

    # decoder QMF-bin energies are 1/4 of the encoder's 64-band analysis
    _QMF_SCALE = 0.25
    _CODEC_DELAY = 2673  # samples@44.1k: aligns envelopes with the output
    # external end-to-end latency: the above plus the one-frame window
    # lookahead (2048 input samples)
    CODEC_LATENCY = 2673 + 2048

    def __init__(self, channels: int = 2, target_maxq: int = TARGET_MAXQ,
                 floor_db: float = -65.0, sbr: bool = True,
                 pns: bool = True, ms: bool = True,
                 intensity: bool = True, sbr_header=None):
        assert channels in (1, 2)
        self.channels = channels
        self.target_maxq = target_maxq
        self.floor = 10.0 ** (floor_db / 20.0)
        self.sbr = sbr
        self.h = _halfband()
        self._dec_state = [np.zeros(len(self.h) - 1) for _ in range(channels)]
        self._prev_core = [np.zeros(A.FRAME_LEN) for _ in range(channels)]
        # one-frame lookahead for window-sequence decisions (see module
        # docstring); seeded with silence so packet k carries frame k-1
        self._pending = {"core": [np.zeros(A.FRAME_LEN)
                                  for _ in range(channels)],
                         "pcm": np.zeros((2 * A.FRAME_LEN, channels)),
                         "transient": False, "attack": -1}
        self._prev_seq = A.ONLY_LONG
        self._e_last = 0.0  # transient detector carry (last block energy)
        self.seq_counts = {s: 0 for s in (A.ONLY_LONG, A.LONG_START,
                                          A.EIGHT_SHORT, A.LONG_STOP)}
        self.ms_frames = 0  # frames coded mid/side (test observability)
        self.tns_channels = 0  # channel-frames that carried a TNS filter
        self.pns = pns
        self.pns_bands = 0  # bands coded as noise substitution
        self.ms = ms
        self.intensity = intensity
        self.is_bands = 0  # bands coded intensity-stereo
        if sbr:
            from nrsc5_tpu_torch.audio.sbr import (QMFAnalysis64, SbrHeader,
                                             derive_tables)
            # crossover ≈6.5 kHz (kx=19), stop ≈15 kHz.  amp_res=0 and
            # xover_band=2 keep every field of this header in the
            # regime where our table derivation and libavcodec's agree
            # band-for-band (test_hdc_external_oracle) — ffmpeg's
            # master-table rounding departs from ours for some other
            # start/stop combinations.
            self._sbr_hdr = sbr_header if sbr_header is not None else \
                SbrHeader(start_freq=8, stop_freq=7,
                          amp_res=0, xover_band=2)
            self._sbr_ft = derive_tables(self._sbr_hdr)
            self._qmf64 = [QMFAnalysis64() for _ in range(channels)]
            self._in_delay = [np.zeros(self._CODEC_DELAY)
                              for _ in range(channels)]
            # the core is band-limited at the crossover (kx QMF bands =
            # kx·32 MDCT bins); cap the coded scalefactor bands there
            core_bins = self._sbr_ft.kx * 32
            offs = A.swb_offsets(False)
            self._max_sfb = max(b for b in range(1, A.num_swb(False) + 1)
                                if offs[b] <= core_bins)
            self._core_bins = int(offs[self._max_sfb])
        else:
            self._max_sfb = A.num_swb(False)
            self._core_bins = A.FRAME_LEN
        # short-window analogs (per-window bins = long bins / 8)
        offs_s = A.swb_offsets(True)
        cap_s = self._core_bins // 8
        self._max_sfb_short = max(b for b in range(1, A.num_swb(True) + 1)
                                  if offs_s[b] <= cap_s)
        self._core_bins_short = int(offs_s[self._max_sfb_short])

    # ------------------------------------------------------------------
    def _detect_transient(self, core_mix: np.ndarray) -> tuple[bool, int]:
        """Attack detector on the 22050 Hz core: a 128-sample block much
        louder than the (decayed) running level before it.  Returns
        (hit, first attack block 0-7 or -1)."""
        e = (core_mix.reshape(8, A.FRAME_LEN // 8) ** 2).mean(axis=1)
        prev = self._e_last
        # only attacks over an established level count (a stream fading in
        # from silence takes the long-window path; ≈ −54 dBFS RMS gate)
        floor = (0.002 * 32768.0) ** 2
        hit = False
        attack = -1
        for blk, v in enumerate(e):
            if prev > floor and v > 12.0 * prev:
                hit = True
                if attack < 0:
                    attack = blk
            prev = max(float(v), prev * 0.7)
        self._e_last = prev
        return hit, attack

    def _intake(self, pcm: np.ndarray) -> "_FramePlan":
        """Shared stateful intake: scale to the faad ±32768 convention,
        decimate to the 22050 Hz core, transient lookahead, plan the
        pending (lookahead-delayed) frame, and stage this one."""
        pcm = np.asarray(pcm, np.float64)
        if pcm.ndim == 1:
            pcm = pcm[:, None]
        assert pcm.shape == (2 * A.FRAME_LEN, self.channels)
        # internal full-scale is ±32768 (the faad convention — keeps SBR
        # envelope values inside their non-negative quantized range)
        pcm = pcm * 32768.0

        # intake: decimate to the 22050 Hz core + transient lookahead
        cores = []
        for ch in range(self.channels):
            x = np.concatenate([self._dec_state[ch], pcm[:, ch]])
            self._dec_state[ch] = x[-(len(self.h) - 1):]
            cores.append(np.convolve(x, self.h, mode="valid")[::2])
        transient, attack = self._detect_transient(
            sum(cores) / self.channels)

        plan = self._plan_pending(next_transient=transient)
        self._pending = {"core": cores, "pcm": pcm,
                         "transient": transient, "attack": attack}
        return plan

    def encode_frame(self, pcm: np.ndarray) -> bytes:
        """pcm: [2048] mono or [2048, 2] stereo float in [-1, 1] at
        44100 Hz -> one HDC packet (carrying the *previous* call's frame;
        a silent frame seeds the pipeline — see the module docstring)."""
        return self._write_hdc(self._intake(pcm))

    def encode_frame_dual(self, pcm: np.ndarray) -> tuple[bytes, bytes]:
        """Like encode_frame, but also serializes the identical frame plan
        as one standard AAC-LC / HE-AAC ADTS frame (for cross-validation
        against an independent decoder such as libavcodec — the spectral
        content, scalefactors, codebooks, TNS filters, M/S-IS decisions
        and SBR envelopes are bit-for-bit the same decisions)."""
        plan = self._intake(pcm)
        return self._write_hdc(plan), self._write_adts(plan)

    def _plan_pending(self, next_transient: bool) -> _FramePlan:
        """Encode the pending (lookahead-delayed) frame; the window
        sequence must splice onto prev's right slope and, if the NEXT
        frame is short, end with a short right slope (ISO 14496-3
        §4.6.11 — the reason LONG_START/LONG_STOP exist)."""
        pend = self._pending
        left_short = self._prev_seq in (A.LONG_START, A.EIGHT_SHORT)
        if pend["transient"] or (left_short and next_transient):
            seq = A.EIGHT_SHORT
        elif next_transient:
            seq = A.LONG_START
        elif left_short:
            seq = A.LONG_STOP
        else:
            seq = A.ONLY_LONG
        self.seq_counts[seq] += 1
        short = seq == A.EIGHT_SHORT

        specs = []
        for ch in range(self.channels):
            core = pend["core"][ch]
            frame2x = np.concatenate([self._prev_core[ch], core])
            self._prev_core[ch] = core
            spec = A.filterbank_analysis(frame2x, seq, 0, 0)
            # band-limit at the SBR crossover
            if short:
                spec = spec.reshape(8, A.SHORT_LEN).copy()
                spec[:, self._core_bins_short:] = 0.0
                spec = spec.reshape(-1)
            else:
                spec[self._core_bins:] = 0.0
            specs.append(spec)
        self._prev_seq = seq

        max_sfb = self._max_sfb_short if short else self._max_sfb
        # TNS (long windows; HDC's implicit n_filt=1): an order-4 LPC
        # along the coded spectrum whitens compact temporal envelopes.
        # It MUST run on the L/R spectra BEFORE the M/S transform: the
        # decoder undoes M/S first and then runs each channel's all-pole
        # filter on the reconstructed L/R — so the exact inverse is
        # all-zero on L/R here, then M/S (codec order: _decode ->
        # _apply_ms_is -> _apply_tns).
        tns_idxs = [None] * self.channels
        if not short:
            for ch in range(self.channels):
                idxs = self._tns_pick(specs[ch], max_sfb)
                if idxs is None:
                    continue
                tns_idxs[ch] = idxs
                self.tns_channels += 1
                ics = IcsInfo(window_sequence=seq, max_sfb=max_sfb)
                ics.tns = TnsInfo(
                    n_filt=[1], coef_res=[1],
                    filt=[[(A.num_swb(False), len(idxs), 0, 0, idxs)]])
                _apply_tns(ics, specs[ch], decode=False)
        has_tns = any(t is not None for t in tns_idxs)

        use_ms = False
        if self.channels == 2:
            # mid/side when the side residual is small (MDCT is linear,
            # so the decision happens in the spectral domain); whole-frame
            # mask (ms_mask_present = 2), exact inverse in the decoder
            # (hdc_decoder._apply_ms_is: l = m + s, r = m - s)
            mid = 0.5 * (specs[0] + specs[1])
            side = 0.5 * (specs[0] - specs[1])
            use_ms = self.ms and float((side * side).sum()) < \
                0.25 * float((mid * mid).sum())
            if use_ms:
                specs = [mid, side]
                self.ms_frames += 1

        # intensity stereo: correlated upper bands of the right channel
        # transmit only a position (scale exponent) relative to the left
        # (decoder: hdc_decoder._apply_ms_is intensity branch).  Skipped
        # on TNS frames: the decoder rebuilds IS bands from the left's
        # still-FIR'd spectrum and then runs the right channel's all-pole
        # over them — with n_filt=1 covering the whole spectrum there is
        # no way to exclude the IS bands from the filter region.
        is_map = None
        if self.channels == 2 and self.intensity and not use_ms \
                and not short and not has_tns:
            offs_l = A.swb_offsets(False)
            is_map = {}
            for b in range(max_sfb // 2, max_sfb):
                left = specs[0][offs_l[b]:offs_l[b + 1]]
                right = specs[1][offs_l[b]:offs_l[b + 1]]
                el, er = float(left @ left), float(right @ right)
                if el < 1e-9 or er < 1e-9:
                    continue
                c = float(left @ right) / np.sqrt(el * er)
                if abs(c) < 0.85:
                    continue
                # scale = 0.5^(pos/4)  =>  pos = -2*log2(Er/El)
                pos = int(np.clip(round(-2.0 * np.log2(er / el)),
                                  -120, 120))
                cb = A.INTENSITY_HCB if c > 0 else A.INTENSITY_HCB2
                is_map[b] = (cb, pos)
                self.is_bands += 1
            if not is_map:
                is_map = None

        chans = []
        for ch in range(self.channels):
            # no PNS inside M/S frames: the decoder skips the M/S
            # butterfly for any band where either channel is NOISE_HCB
            # (hdc_decoder._apply_ms_is), which would leave that band's
            # L/R as raw mid/side noise instead of the reconstruction
            chp = self._plan_channel(specs[ch], max_sfb, short,
                                     is_map if ch == 1 else None,
                                     allow_pns=not use_ms)
            chp.tns_idxs = tns_idxs[ch]
            chans.append(chp)
        env_rows, sbr_grid = (None, None)
        if self.sbr:
            attack = pend["attack"] if pend["transient"] else -1
            env_rows, sbr_grid = self._plan_sbr(pend["pcm"], attack)
        return _FramePlan(seq=seq, max_sfb=max_sfb, use_ms=use_ms,
                          chans=chans, env_rows=env_rows,
                          sbr_grid=sbr_grid)

    # ------------------------------------------------------------------
    # serializers: HDC packet / standard AAC ADTS frame
    # ------------------------------------------------------------------
    def _write_hdc(self, plan: _FramePlan) -> bytes:
        """Serialize a frame plan in HDC packet syntax (the bitstream of
        support/faad2-hdc-support.patch hdc_data_block)."""
        short = plan.short
        bw = BitWriter()
        bw.write(2 if self.channels == 2 else 0, LEN_SE_ID)  # block type
        # shared compact ics header (hdc_data_frame)
        bw.write(0, 1)              # ics_reserved_bit
        bw.write(0, 1)              # window_shape: sine
        bw.write(plan.seq, 2)       # window_sequence
        if short:
            bw.write(plan.max_sfb, 4)
            bw.write(0x7F, 7)       # grouping: one group of 8 windows
        else:
            bw.write(plan.max_sfb, 6)
        if self.channels == 2:
            bw.write(2 if plan.use_ms else 0, 2)  # ms_mask_present
        for chp in plan.chans:
            if chp.tns_idxs is None:
                bw.write(0, 1)      # tns_data_present
                continue
            bw.write(1, 1)          # tns_data_present
            # long window: n_filt implicit (patch:920-929)
            bw.write(1, 1)          # coef_res = 1 (4-bit coefficients)
            bw.write(A.num_swb(False), 6)  # length: whole coded spectrum
            bw.write(len(chp.tns_idxs), 5)  # order
            bw.write(0, 1)          # direction: forward
            bw.write(0, 1)          # compress: none
            for c in chp.tns_idxs:
                bw.write(int(c), 4)
        for chp in plan.chans:
            self._write_channel(bw, chp, plan.max_sfb, short)
        if plan.env_rows is not None:
            bw.write(ID_FIL, LEN_SE_ID)
            bw.write(1, 1)          # SBR present (patch:826-830)
            self._write_sbr_body(bw, plan.env_rows, hdc=True,
                                 grid=plan.sbr_grid)
        return bw.getvalue()

    def _write_adts(self, plan: _FramePlan) -> bytes:
        """Serialize the same frame plan as one standard ISO 14496-3
        AAC-LC raw_data_block in an ADTS frame (HE-AAC via the implicit
        SBR fill element when the plan carries envelopes), so an
        independent decoder (libavcodec) can decode identical spectral
        content — the external PCM oracle for the clean-room codec."""
        short = plan.short
        stereo = self.channels == 2
        bw = BitWriter()

        def ics_info():
            # standard ics_info field order (reserved, SEQUENCE, shape —
            # HDC swaps shape/sequence)
            bw.write(0, 1)          # ics_reserved_bit
            bw.write(plan.seq, 2)   # window_sequence
            bw.write(0, 1)          # window_shape: sine
            if short:
                bw.write(plan.max_sfb, 4)
                bw.write(0x7F, 7)   # grouping
            else:
                bw.write(plan.max_sfb, 6)
                bw.write(0, 1)      # predictor_data_present (LC: none)

        if stereo:
            bw.write(1, 3)          # id_syn_ele: CPE
            bw.write(0, 4)          # element_instance_tag
            bw.write(1, 1)          # common_window
            ics_info()
            bw.write(2 if plan.use_ms else 0, 2)  # ms_mask_present
        else:
            bw.write(0, 3)          # id_syn_ele: SCE
            bw.write(0, 4)
        for chp in plan.chans:
            bw.write(chp.global_gain, 8)
            if not stereo:
                ics_info()          # SCE: ics_info inside the ics
            self._write_sections(bw, chp, plan.max_sfb, short)
            self._write_scalefactors(bw, chp, plan.max_sfb)
            bw.write(0, 1)          # pulse_data_present
            if chp.tns_idxs is None:
                bw.write(0, 1)      # tns_data_present
            else:
                bw.write(1, 1)
                bw.write(1, 2)      # n_filt (explicit in standard AAC)
                bw.write(1, 1)      # coef_res = 1
                bw.write(A.num_swb(False), 6)
                bw.write(len(chp.tns_idxs), 5)
                bw.write(0, 1)      # direction
                bw.write(0, 1)      # compress
                for c in chp.tns_idxs:
                    bw.write(int(c), 4)
            bw.write(0, 1)          # gain_control_data_present
            self._write_spectral(bw, chp, plan.max_sfb)
        if plan.env_rows is not None:
            # FIL element carrying extension_payload(EXT_SBR_DATA)
            sbr = BitWriter()
            sbr.write(13, 4)        # extension_type: EXT_SBR_DATA
            self._write_sbr_body(sbr, plan.env_rows, hdc=False,
                                 grid=plan.sbr_grid)
            cnt = (sbr.bit_length() + 7) // 8
            bw.write(ID_FIL, LEN_SE_ID)
            if cnt >= 15:
                bw.write(15, 4)
                bw.write(cnt - 15 + 1, 8)   # esc_count
            else:
                bw.write(cnt, 4)
            payload = sbr.getvalue()
            for byte in payload:
                bw.write(byte, 8)
            for _ in range(cnt - len(payload)):
                bw.write(0, 8)
        bw.write(7, 3)              # id_syn_ele: END
        raw = bw.getvalue()
        # ADTS fixed+variable header (no CRC): MPEG-4, AAC-LC, 22050 Hz
        hdr = BitWriter()
        hdr.write(0xFFF, 12)        # syncword
        hdr.write(0, 1)             # ID: MPEG-4
        hdr.write(0, 2)             # layer
        hdr.write(1, 1)             # protection_absent
        hdr.write(1, 2)             # profile: AAC-LC (object type 2 - 1)
        hdr.write(A.SF_INDEX_22050, 4)
        hdr.write(0, 1)             # private
        hdr.write(self.channels, 3)  # channel_configuration
        hdr.write(0, 1)             # original/copy
        hdr.write(0, 1)             # home
        hdr.write(0, 1)             # copyright_identification_bit
        hdr.write(0, 1)             # copyright_identification_start
        hdr.write(7 + len(raw), 13)  # aac_frame_length incl. header
        hdr.write(0x7FF, 11)        # adts_buffer_fullness: VBR
        hdr.write(0, 2)             # number_of_raw_data_blocks_in_frame
        return hdr.getvalue() + raw

    # ------------------------------------------------------------------
    def _plan_sbr(self, pcm: np.ndarray, attack: int = -1):
        """Measure SBR envelope rows per channel.

        Envelope energies are measured from the (delay-aligned) input
        through the 64-band analysis bank, so the decoder's HF adjustment
        reproduces the source's high-band spectral envelope.

        ``attack`` (core block 0-7, or -1): a transient frame emits a
        TWO-envelope variable grid with the border at the attack and
        l_A pointing at the second envelope (the way real encoders
        signal transients) — this exercises the decoder's per-envelope
        delta/noise gating and the smoothing-filter bypass.  Returns
        (env_rows [ch][env], grid dict or None)."""
        ft = self._sbr_ft
        grid = None
        segs = [(0, 32)]
        if attack >= 0:
            # border in half-slot (nts) units, even, clipped inside the
            # representable variable-grid range (see _write_grid)
            border = int(np.clip(2 * max(attack, 1), 2, 14))
            grid = {"border": border}
            segs = [(0, 2 * border), (2 * border, 32)]  # QMF slot ranges
        env_rows = []
        for ch in range(self.channels):
            buf = np.concatenate([self._in_delay[ch], pcm[:, ch]])
            self._in_delay[ch] = buf[-self._CODEC_DELAY:]
            x64 = self._qmf64[ch].run(buf[:2 * A.FRAME_LEN])  # [32, 64]
            rows = []
            for lo, hi in segs:
                e_bin = (np.abs(x64[lo:hi]) ** 2).mean(axis=0) \
                    * self._QMF_SCALE
                row = np.zeros(ft.n_high, np.int32)
                for b in range(ft.n_high):
                    e = e_bin[int(ft.f_high[b]):
                              int(ft.f_high[b + 1])].mean()
                    # forced 1.5 dB resolution (amp_res 0): a = 2
                    row[b] = int(np.clip(
                        round(2.0 * np.log2(max(e, 1e-9) / 64.0)),
                        0, 127))
                rows.append(row)
            env_rows.append(rows)
        return env_rows, grid

    def _write_sbr_body(self, bw: BitWriter, env_rows: list, hdc: bool,
                        grid: dict | None = None):
        """sbr_header + sbr_data (FIXFIX, 1 envelope, per channel).

        The payload syntax is shared between HDC's fill element
        (patch: hdc_sbr_data_block) and standard sbr_extension_data —
        the only in-body divergence is one HDC extra bit in the mono
        path (patch:577-582)."""
        ft = self._sbr_ft
        bw.write(1, 1)              # bs_header_flag: every packet
        h = self._sbr_hdr
        bw.write(h.amp_res, 1)
        bw.write(h.start_freq, 4)
        bw.write(h.stop_freq, 4)
        bw.write(h.xover_band, 3)
        bw.write(0, 2)              # reserved
        extra1 = (h.freq_scale, h.alter_scale, h.noise_bands) != (2, 1, 2)
        extra2 = (h.limiter_bands, h.limiter_gains, h.interpol_freq,
                  h.smoothing_mode) != (2, 2, 1, 1)
        bw.write(int(extra1), 1)    # header_extra_1
        bw.write(int(extra2), 1)    # header_extra_2
        if extra1:
            bw.write(h.freq_scale, 2)
            bw.write(h.alter_scale, 1)
            bw.write(h.noise_bands, 2)
        if extra2:
            bw.write(h.limiter_bands, 2)
            bw.write(h.limiter_gains, 2)
            bw.write(h.interpol_freq, 1)
            bw.write(h.smoothing_mode, 1)

        n_env = len(env_rows[0])
        n_noise = 1 if n_env == 1 else 2
        if self.channels == 2:
            bw.write(0, 1)          # bs_data_extra
            bw.write(0, 1)          # bs_coupling: off
            for _ in range(2):
                self._write_grid(bw, grid)
            for _ in range(2):
                for _ in range(n_env):
                    bw.write(0, 1)  # df_env: freq delta per envelope
                for _ in range(n_noise):
                    bw.write(0, 1)  # df_noise
            for _ in range(2):
                for _ in range(ft.n_q):
                    bw.write(2, 2)  # invf mode: medium
            for ch in range(2):
                for row in env_rows[ch]:
                    self._write_envelope(bw, row)
            for _ in range(2):
                for _ in range(n_noise):
                    self._write_noise(bw)
            for _ in range(2):
                bw.write(0, 1)      # bs_add_harmonic_flag
            bw.write(0, 1)          # bs_extended_data
        else:
            bw.write(0, 1)          # bs_data_extra
            if hdc:
                bw.write(0, 1)      # HDC extra bit (patch:577-582)
            self._write_grid(bw, grid)
            for _ in range(n_env):
                bw.write(0, 1)      # df_env
            for _ in range(n_noise):
                bw.write(0, 1)      # df_noise
            for _ in range(ft.n_q):
                bw.write(2, 2)
            for row in env_rows[0]:
                self._write_envelope(bw, row)
            for _ in range(n_noise):
                self._write_noise(bw)
            bw.write(0, 1)          # bs_add_harmonic_flag
            bw.write(0, 1)          # bs_extended_data

    @staticmethod
    def _write_grid(bw: BitWriter, grid: dict | None = None):
        """FIXFIX 1-envelope (grid None), or a 2-envelope variable grid
        with the border at grid["border"] (half-slot units, even, 2-14)
        and l_A on the second envelope — VARFIX encodes borders growing
        from the frame start (reachable borders 2-8 with vb=0), FIXVAR
        shrinking from the end (10-14), mirroring sbr.parse_sbr_grid."""
        if grid is None:
            bw.write(0, 2)          # FIXFIX
            bw.write(0, 2)          # 1 envelope
            bw.write(1, 1)          # freq_res: high
            return
        b = grid["border"]
        assert b % 2 == 0 and 2 <= b <= 14, b
        if b <= 8:
            bw.write(2, 2)          # VARFIX
            bw.write(0, 2)          # bs_var_bord_0 = 0
            bw.write(1, 2)          # one relative border
            bw.write((b - 2) // 2, 2)   # rel = 2k+2 = b
            # la = ptr-1 if ptr > 1 -> ptr=2 marks envelope 1
            bw.write(2, 2)          # bs_pointer (ceil_log2(3) = 2 bits)
            bw.write(1, 1)          # freq_res env 0: high
            bw.write(1, 1)          # freq_res env 1: high
        else:
            bw.write(1, 2)          # FIXVAR
            bw.write(0, 2)          # bs_var_bord_1 = 0 (end = 16)
            bw.write(1, 2)          # one relative border
            bw.write((16 - b - 2) // 2, 2)  # rel = 16 - b
            # la = n_env+1-ptr -> ptr=2 marks envelope 1
            bw.write(2, 2)          # bs_pointer
            # FIXVAR freq_res bits are serialized last-envelope-first
            bw.write(1, 1)
            bw.write(1, 1)

    def _write_envelope(self, bw: BitWriter, row):
        from nrsc5_tpu_torch.audio.sbr import HUFF_ENV15_F
        bw.write(int(np.clip(row[0], 0, 127)), 7)  # amp_res 0 start
        prev = int(row[0])
        for b in range(1, len(row)):
            # +-28, not the table's +-60: all f_huffman_env_1.5dB codes
            # for |delta| <= 28 are <= 18 bits, the VLC depth real
            # decoders resolve (ffmpeg get_vlc2 max_depth=2 = 9x2 bits;
            # codes further out run 19-20 bits and are undecodable
            # there) — a 28-step = 42 dB band-to-band swing loses
            # nothing in practice
            delta = int(np.clip(int(row[b]) - prev, -28, 28))
            HUFF_ENV15_F.encode(bw, delta + 60)
            prev += delta

    def _write_noise(self, bw: BitWriter):
        from nrsc5_tpu_torch.audio.sbr import HUFF_NOISE_F
        bw.write(22, 5)             # moderate fixed noise floor
        for _ in range(self._sbr_ft.n_q - 1):
            HUFF_NOISE_F.encode(bw, 0 + 31)  # delta 0

    # ------------------------------------------------------------------
    def _tns_pick(self, spec: np.ndarray, max_sfb: int,
                  order: int = 4, min_gain: float = 3.0):
        """Order-``order`` LPC along the coded spectrum (Levinson-Durbin);
        returns 4-bit arcsine-table coefficient indices when the
        prediction gain clears ``min_gain``, else None."""
        offs = A.swb_offsets(False)
        nbands = min(max_sfb, A.tns_max_bands(False))
        seg = spec[:int(offs[nbands])].astype(np.float64)
        r = np.array([seg[:len(seg) - m] @ seg[m:]
                      for m in range(order + 1)])
        if r[0] <= 0:
            return None
        a = np.zeros(order + 1)
        a[0], e, ks = 1.0, float(r[0]), []
        for m in range(1, order + 1):
            acc = r[m] + sum(a[i] * r[m - i] for i in range(1, m))
            k = -acc / e
            if not np.isfinite(k) or abs(k) >= 0.999:
                return None
            b = a.copy()
            for i in range(1, m):
                b[i] = a[i] + k * a[m - i]
            b[m] = k
            a, e = b, e * (1 - k * k)
            ks.append(k)
        if r[0] / e < min_gain:
            return None
        # quantize reflection coefficients to the decoder's (coef_res=1,
        # compress=0) table; the decoder rebuilds the identical predictor.
        # The libavcodec-extracted table is negated vs the faad/ISO
        # convention (_tns_lpc negates on read), so quantize -k
        tab = np.asarray(TBL.TNS_TMP2_MAP_0_4, np.float64)
        idxs = [int(np.argmin(np.abs(tab + k))) for k in ks]
        if all(abs(tab[i]) < 1e-9 for i in idxs):
            return None
        return idxs

    def _plan_channel(self, spec: np.ndarray, max_sfb: int,
                      short: bool = False, is_map: dict | None = None,
                      allow_pns: bool = True) -> _ChPlan:
        offs = A.swb_offsets(short)
        # EIGHT_SHORT uses one group of all 8 windows: each sfb's band is
        # the window-major concatenation (decoder scatter:
        # hdc_decoder._parse_spectral vals.reshape(glen, width))
        windows = spec.reshape(8, A.SHORT_LEN) if short else None
        sfs = np.zeros(max_sfb, np.int32)
        cbs = np.zeros(max_sfb, np.int32)
        quants = []
        frame_peak = np.abs(spec).max()
        T = self.target_maxq
        prev_sf = None
        for b in range(max_sfb):
            band = (windows[:, offs[b]:offs[b + 1]].ravel() if short
                    else spec[offs[b]:offs[b + 1]])
            if is_map and b in is_map:
                cbs[b], sfs[b] = is_map[b]  # position, no spectral data
                quants.append(np.zeros(len(band), np.int64))
                continue
            peak = np.abs(band).max()
            if peak < 1e-6 or peak < frame_peak * self.floor:
                # below the coding floor: substitute noise at the measured
                # band energy (PNS, long windows) instead of silence —
                # decoder fills noise with TOTAL band energy 2^(nrg/2)
                # (ISO/faad convention; hdc_decoder NOISE_HCB branch)
                etot = float((band.astype(np.float64) ** 2).sum())
                if self.pns and allow_pns and not short and \
                        etot > 1e-6 * len(band):
                    cbs[b] = A.NOISE_HCB
                    sfs[b] = int(np.clip(round(2 * np.log2(etot)),
                                         -100, 155))
                    self.pns_bands += 1
                quants.append(np.zeros(len(band), np.int64))
                continue
            # scalefactor so the band peak quantizes near TARGET_MAXQ:
            # (peak·2^{−(sf−100)/4})^{3/4} ≤ T  ⇒  sf ≥ 100 + 4·log2 peak
            # − (16/3)·log2 T
            sf = int(np.ceil(100 + 4.0 * np.log2(peak)
                             - (16.0 / 3.0) * np.log2(T + 0.4)))
            sf = int(np.clip(sf, 0, 255))
            # clamp to the ±60 dpcm range BEFORE quantizing, so the
            # written scalefactor is always the one the band was
            # quantized with
            if prev_sf is not None:
                sf = int(np.clip(sf, prev_sf - 60, prev_sf + 60))
            q = A.quant(band, sf)
            maxq = int(np.abs(q).max())
            if maxq == 0:
                quants.append(np.zeros(len(band), np.int64))
                continue
            cb = A.ESC_HCB
            for lav, book in _BOOK_BY_MAX:
                if maxq <= lav:
                    cb = book
                    break
            sfs[b], cbs[b] = sf, cb
            prev_sf = sf
            quants.append(q)

        # global_gain anchors the REGULAR scalefactor chain only (noise
        # bands live on their own chain seeded at global_gain - 90)
        first = next((b for b in range(max_sfb)
                      if cbs[b] and cbs[b] < A.NOISE_HCB), None)
        global_gain = int(sfs[first]) if first is not None else 100
        return _ChPlan(cbs=cbs, sfs=sfs, quants=quants,
                       global_gain=global_gain, tns_idxs=None)

    def _write_channel(self, bw: BitWriter, chp: _ChPlan, max_sfb: int,
                       short: bool):
        """HDC per-channel side info + spectral data (side_info with
        scal_flag=1: global gain + sections + scalefactors)."""
        bw.write(chp.global_gain, 8)
        self._write_sections(bw, chp, max_sfb, short)
        self._write_scalefactors(bw, chp, max_sfb)
        self._write_spectral(bw, chp, max_sfb)

    @staticmethod
    def _write_sections(bw: BitWriter, chp: _ChPlan, max_sfb: int,
                        short: bool):
        # section data: runs of equal codebook (3/5-bit lengths with esc)
        cbs = chp.cbs
        sect_bits = 3 if short else 5
        esc = (1 << sect_bits) - 1
        b = 0
        while b < max_sfb:
            run = 1
            while b + run < max_sfb and cbs[b + run] == cbs[b]:
                run += 1
            bw.write(int(cbs[b]), 4)
            r = run
            while r >= esc:
                bw.write(esc, sect_bits)
                r -= esc
            bw.write(r, sect_bits)
            b += run

    @staticmethod
    def _write_scalefactors(bw: BitWriter, chp: _ChPlan, max_sfb: int):
        # scalefactors: huffman dpcm from global_gain; noise bands ride
        # their own chain (first: 9-bit PCM, then SF_HUFF deltas —
        # hdc_decoder._parse_scale_factors NOISE_HCB branch)
        cbs, sfs = chp.cbs, chp.sfs
        prev = chp.global_gain
        noise_prev, noise_pcm = chp.global_gain - 90, True
        is_prev = 0  # intensity-position chain seeds at 0
        for b in range(max_sfb):
            cb = int(cbs[b])
            if cb == 0:
                continue
            if cb in (A.INTENSITY_HCB, A.INTENSITY_HCB2):
                pos = int(np.clip(int(sfs[b]), is_prev - 60, is_prev + 60))
                SF_HUFF.encode(bw, pos - is_prev + A.SF_CENTER)
                is_prev = pos
                continue
            if cb == A.NOISE_HCB:
                nrg = int(sfs[b])
                if noise_pcm:
                    nrg = int(np.clip(nrg, noise_prev - 256,
                                      noise_prev + 255))
                    bw.write(nrg - noise_prev + 256, 9)
                    noise_pcm = False
                else:
                    nrg = int(np.clip(nrg, noise_prev - 60,
                                      noise_prev + 60))
                    SF_HUFF.encode(bw, nrg - noise_prev + A.SF_CENTER)
                noise_prev = nrg
                continue
            SF_HUFF.encode(bw, int(sfs[b]) - prev + A.SF_CENTER)
            prev = int(sfs[b])

    def _write_spectral(self, bw: BitWriter, chp: _ChPlan, max_sfb: int):
        # spectral data (noise bands carry none)
        cbs, quants = chp.cbs, chp.quants
        for b in range(max_sfb):
            cb = int(cbs[b])
            if cb == 0 or cb >= A.NOISE_HCB:
                continue
            q = quants[b]
            dim, lav, signed = A.CB_META[cb]
            huff = SPEC_HUFF[cb]
            for i in range(0, len(q), dim):
                tup = [int(v) for v in q[i:i + dim]]
                if cb == A.ESC_HCB:
                    coded = [min(abs(v), 16) if not signed else v
                             for v in tup]
                elif not signed:
                    coded = [abs(v) for v in tup]
                else:
                    coded = tup
                huff.encode(bw, A.pack_index(cb, coded))
                if not signed:
                    for v, c in zip(tup, coded):
                        if c:
                            bw.write(0 if v >= 0 else 1, 1)
                if cb == A.ESC_HCB:
                    for v in tup:
                        if abs(v) >= 16:
                            self._write_escape(bw, abs(v))

    @staticmethod
    def _write_escape(bw: BitWriter, value: int):
        assert value >= 16
        n = value.bit_length() - 1  # value in [2^n, 2^(n+1))
        for _ in range(n - 4):
            bw.write(1, 1)
        bw.write(0, 1)
        bw.write(value - (1 << n), n)
