"""NRSC-5 protocol constants.

These are protocol-defined facts of the NRSC-5 (HD Radio) standard
(1011s/1012s/1014s), cross-checked against the reference implementation
(reference: src/defines.h, src/sync.c, src/decode.c).  They parameterize the
PyTorch receive chain in this package.

A copy of ``nrsc5_tpu/constants.py``: the port imports nothing of the JAX
package, and tests/test_torch_tables.py pins every value equal.
"""

from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------------------
# Sample rates (reference: include/nrsc5.h:53-56)
# ---------------------------------------------------------------------------
SAMPLE_RATE_CU8 = 1_488_375.0  # raw SDR rate (both FM and AM front ends)
SAMPLE_RATE_CS16_FM = 744_187.5  # internal FM complex rate (cu8 / 2)
SAMPLE_RATE_CS16_AM = 46_511.71875  # internal AM complex rate (cu8 / 32)
SAMPLE_RATE_AUDIO = 44_100  # decoded PCM rate
AUDIO_FRAME_SAMPLES = 2048  # PCM samples per HDC frame

# ---------------------------------------------------------------------------
# OFDM parameters (reference: src/defines.h:11-22)
# ---------------------------------------------------------------------------
FFT_FM = 2048
FFT_AM = 256
CP_FM = 112
CP_AM = 14
FFTCP_FM = FFT_FM + CP_FM  # 2160 samples per FM OFDM symbol
FFTCP_AM = FFT_AM + CP_AM  # 270 samples per AM OFDM symbol
BLKSZ = 32  # OFDM symbols per L1 block
ACQUIRE_SYMBOLS = BLKSZ  # symbols consumed per acquire invocation

# FM subcarrier layout (fftshifted bin indices; bin FFT_FM/2 == DC)
# (reference: src/defines.h:23-26)
LB_START = FFT_FM // 2 - 546  # first lower-sideband subcarrier (478)
UB_END = FFT_FM // 2 + 546  # last upper-sideband subcarrier (1570)

# AM subcarrier layout (reference: src/defines.h:27-36)
CENTER_AM = FFT_AM // 2
REF_INDEX_AM = 1
PIDS_INNER_INDEX_AM = 27
PIDS_OUTER_INDEX_AM = 53
INNER_PARTITION_START_AM = 2
MIDDLE_PARTITION_START_AM = 28
OUTER_PARTITION_START_AM = 57
MAX_INDEX_AM = 81

# AM service modes (reference: src/defines.h:37-39)
SERVICE_MODE_MA1 = 1
SERVICE_MODE_MA3 = 2

# ---------------------------------------------------------------------------
# Partitions (reference: src/defines.h:72-81)
# ---------------------------------------------------------------------------
PARTITION_WIDTH_AM = 25
PARTITION_WIDTH_FM = 19
PARTITION_DATA_CARRIERS = 18  # carriers 1..18 of each FM partition carry data
PM_PARTITIONS = 10  # partitions per Primary Main sideband
MAX_PARTITIONS = 14  # widest extended mode (MP5/MP6/MP11)
MIDDLE_REF_SC = 30  # reference-subcarrier id midpoint (1011s table 11-3)

# soft bits per L1 block from the PM partitions (2 sidebands x 10 partitions
# x 18 data carriers x 2 bits/QPSK x 32 symbols) = 23040
PM_BLOCK_SIZE = 2 * 2 * PM_PARTITIONS * PARTITION_DATA_CARRIERS * BLKSZ

# ---------------------------------------------------------------------------
# Frame sizes in bits (reference: src/defines.h:40-65)
# ---------------------------------------------------------------------------
P1_FRAME_LEN_FM = 146176
P1_FRAME_LEN_AM = 3750
P1_FRAME_LEN_ENCODED_FM = P1_FRAME_LEN_FM * 5 // 2  # rate 2/5 -> 365440
P1_FRAME_LEN_ENCODED_AM = P1_FRAME_LEN_AM * 12 // 5  # rate 5/12 -> 9000
PIDS_FRAME_LEN = 80
PIDS_FRAME_LEN_ENCODED_FM = PIDS_FRAME_LEN * 5 // 2  # 200
PIDS_FRAME_LEN_ENCODED_AM = PIDS_FRAME_LEN * 3  # 240
P3_FRAME_LEN_MP2 = 2304
P3_FRAME_LEN_MP3_MP11 = 4608
P3_FRAME_LEN_MA1 = 24000
P3_FRAME_LEN_MA3 = 30000
P3_FRAME_LEN_ENCODED_MA1 = P3_FRAME_LEN_MA1 * 3 // 2
P3_FRAME_LEN_ENCODED_MA3 = P3_FRAME_LEN_MA3 * 12 // 5
PCI_LEN = 24
MAX_PDU_LEN = (P1_FRAME_LEN_FM - PCI_LEN) // 8  # 18269 bytes
P1_PDU_LEN_AM = 466
MAX_PROGRAMS = 8
MAX_STREAMS = 2
ELASTIC_BUFFER_LEN = 64
DIVERSITY_DELAY_AM = 3 * 18000  # AM diversity delay line length in bits

# blocks per P1 FM frame
P1_FM_BLOCKS = 16
# blocks per AM frame
P1_AM_BLOCKS = 8

# ---------------------------------------------------------------------------
# Convolutional codes (reference: src/decode.c:39-61, src/conv_dec.c:455-478)
# Generators in octal; all codes rate-1/3 mother, tail-biting.
# ---------------------------------------------------------------------------
CONV_K7_GEN = (0o133, 0o171, 0o165)  # FM P1/PIDS/P3/P4
CONV_E1_GEN = (0o561, 0o657, 0o711)  # AM K=9 (P1, P3 MA3)
CONV_E2_E3_GEN = (0o561, 0o753, 0o711)  # AM K=9 (P3 MA1, PIDS)

# Puncture patterns over the rate-1/3 mother code output
# (reference: src/decode.c:263-277 and depuncture sites 319,339,370,184-230)
PUNCTURE_P1_PIDS_FM = (1, 1, 1, 1, 1, 0)  # rate 2/5
PUNCTURE_P3_P4_FM = (1, 0, 1, 1, 0, 1)  # rate 1/2
PUNCTURE_E1 = (1, 0, 1, 1, 0, 1, 1, 0, 1, 1, 1, 1, 1, 1, 1)  # rate 5/12
PUNCTURE_E2 = (1, 0, 1, 1, 0, 0)  # rate 2/3 (derived: kept sites i%6 in {0,2,3})

# ---------------------------------------------------------------------------
# Scrambler (reference: src/decode.c:279-294)
# 11-bit LFSR, feedback (v>>9 ^ v) & 1, seeded with 0x3ff. The keystream is
# fixed, so it is precomputed once (see ops/scramble.py).
# ---------------------------------------------------------------------------
SCRAMBLER_WIDTH = 11
SCRAMBLER_SEED = 0x3FF

# ---------------------------------------------------------------------------
# PM interleaver partition sequence V (1012s figure 10-?; reference:
# src/decode.c:34-37)
# ---------------------------------------------------------------------------
PM_V = (10, 2, 18, 6, 14, 8, 16, 0, 12, 4, 11, 3, 19, 7, 15, 9, 17, 1, 13, 5)

# AM PIDS bit-delay tables (1012s figure 10-5; reference: src/decode.c:64-65)
PIDS_IL_DELAY = (0, 1, 12, 13, 6, 5, 18, 17, 11, 7, 23, 19)
PIDS_IU_DELAY = (2, 4, 14, 16, 3, 8, 15, 20, 9, 10, 21, 22)

# AM MA1 interleaver delay tables (1012s figure 10-4; reference:
# src/decode.c:27-32)
BL_DELAY = (2, 1, 5)
ML_DELAY = (11, 6, 7)
BU_DELAY = (10, 8, 9)
MU_DELAY = (4, 3, 0)
EL_DELAY = (0, 1)
EU_DELAY = (2, 3, 5, 4)

# ---------------------------------------------------------------------------
# Service mode (psmi) -> compatibility mode (1011s table 6-4; reference:
# src/sync.c:30-35)
# ---------------------------------------------------------------------------
COMPATIBILITY_MODE = (
    0, 1, 2, 3, 1, 5, 6, 5, 6, 1, 2, 11, 1, 5, 6, 5,
    6, 1, 2, 3, 1, 5, 6, 5, 6, 1, 2, 11, 1, 5, 6, 5,
    6, 1, 2, 3, 1, 5, 6, 5, 6, 1, 2, 11, 1, 5, 6, 5,
    6, 1, 2, 3, 1, 5, 6, 5, 6, 1, 2, 11, 1, 5, 6, 5,
)


def partitions_per_band(psmi: int) -> int:
    """Number of occupied FM partitions per sideband for a service mode.

    (reference: src/sync.c:341-357)
    """
    cm = COMPATIBILITY_MODE[psmi]
    if cm == 2:
        return 11
    if cm == 3:
        return 12
    if cm in (5, 6, 11):
        return 14
    return 10


# ---------------------------------------------------------------------------
# FM reference-subcarrier system-control sequence.
#
# Each reference subcarrier carries one DBPSK symbol per OFDM symbol; over a
# 32-symbol block the *transmitted sign sequence* s[0..31] has fixed sync
# positions and variable fields.  REF_SIGNS_FIXED holds the fixed signs with
# -1 for variable positions (this is the "needle" the receiver matches;
# reference: src/sync.c:170-174,96-99).  Bit fields (positions within the
# DBPSK-decoded data d[n] = s[n] ^ s[n-1], s[-1] = 0):
#   d[16..19] = block count (bc), MSB first
#   d[25..30] = primary service mode (psmi), MSB first
# The per-subcarrier 2-bit id rsid is gray coded into signs s[10], s[11].
# ---------------------------------------------------------------------------
REF_SIGNS_FIXED = (
    0, 1, 0, 0, 0, 1, 1, -1, 1, 0, -1, -1, -1, 0, 0, -1,
    -1, -1, -1, -1, 0, 1, 0, -1, -1, -1, -1, -1, -1, -1, -1, 0,
)

# AM reference subcarrier sign sequence (imaginary axis; reference:
# src/sync.c:211-213,243-245).  Parity constraints (src/sync.c:223-227):
#   s7==s8;  s10^s11^s12^s13==0;  s15^..^s20==0;  s23^..^s31==0
AM_REF_SIGNS_FIXED = (
    0, 1, 1, 0, 0, 1, 0, -1, -1, 1, -1, -1, -1, -1, 0, -1,
    -1, -1, -1, -1, -1, 1, 1, -1, -1, -1, -1, -1, -1, -1, -1, -1,
)

# ---------------------------------------------------------------------------
# Reed-Solomon header FEC: RS(255,247) over GF(2^8), gfpoly 0x11d, fcr=1,
# prim=1, 8 parity symbols, used shortened to 96-byte codewords
# (reference: src/frame.h:5-8, src/rs_init.c, src/frame.c:158-179)
# ---------------------------------------------------------------------------
RS_BLOCK_LEN = 255
RS_CODEWORD_LEN = 96
RS_PARITY_LEN = 8
RS_GFPOLY = 0x11D
RS_FCR = 1
RS_PRIM = 1

# ---------------------------------------------------------------------------
# L2 PCI patterns (reference: src/frame.c:24-28)
# ---------------------------------------------------------------------------
PCI_AUDIO = 0x38D8D3
PCI_AUDIO_OPP = 0xCE3634
PCI_AUDIO_FIXED = 0xE3634C
PCI_AUDIO_FIXED_OPP = 0x8D8D33
PCI_FIXED = 0x3634CE

MAX_AUDIO_PACKETS = 64

# ---------------------------------------------------------------------------
# Front-end filters.
#
# DECIM_TAPS: prototype for the q15 halfband decimator cascade (designed with
# the GNU Radio filter tool; reference: src/input.c:26-39).  The full 15-tap
# halfband impulse response is h = [t3 0 t2 0 t1 0 t0 1 t0 0 t1 0 t2 0 t3]/2
# with unity DC gain after the /2 decimation sum.
#
# ACQ_TAPS_FM / ACQ_TAPS_AM: band-shaping FIR used only inside the coarse
# timing correlator (reference: src/acquire.c:28-96), 32 taps, group delay 15.
# ---------------------------------------------------------------------------
DECIM_TAPS = (
    0.6062333583831787,
    -0.13481467962265015,
    0.032919470220804214,
    -0.00410953676328063,
)

ACQ_TAPS_FM = (
    -0.000685643230099231, 0.005636964458972216, 0.009015781804919243,
    -0.015486305579543114, -0.035108357667922974, 0.017446253448724747,
    0.08155813068151474, 0.007995186373591423, -0.13311293721199036,
    -0.0727422907948494, 0.15914097428321838, 0.16498781740665436,
    -0.1324498951435089, -0.2484012246131897, 0.051773931831121445,
    0.2821577787399292, 0.051773931831121445, -0.2484012246131897,
    -0.1324498951435089, 0.16498781740665436, 0.15914097428321838,
    -0.0727422907948494, -0.13311293721199036, 0.007995186373591423,
    0.08155813068151474, 0.017446253448724747, -0.035108357667922974,
    -0.015486305579543114, 0.009015781804919243, 0.005636964458972216,
    -0.000685643230099231, 0.0,
)

ACQ_TAPS_AM = (
    -0.00038464731187559664, -0.00021618751634377986, 0.0026779419276863337,
    -0.00029802651260979474, -0.0012626448879018426, -0.0013182522961869836,
    -0.012252614833414555, 0.015980124473571777, 0.037112727761268616,
    -0.05451361835002899, -0.05804193392395973, 0.11320608854293823,
    0.055298302322626114, -0.16878043115139008, -0.022917453199625015,
    0.19178225100040436, -0.022917453199625015, -0.16878043115139008,
    0.055298302322626114, 0.11320608854293823, -0.05804193392395973,
    -0.05451361835002899, 0.037112727761268616, 0.015980124473571777,
    -0.012252614833414555, -0.0013182522961869836, -0.0012626448879018426,
    -0.00029802651260979474, 0.0026779419276863337, -0.00021618751634377986,
    -0.00038464731187559664, 0.0,
)

ACQ_FILTER_DELAY = 15


def ofdm_shape(fft: int, cp: int) -> np.ndarray:
    """Raised-cosine pulse shaping window of length fft+cp.

    w[i] = sin(pi/2 * i/cp) for i < cp; 1 for cp <= i < fft;
    cos(pi/2 * (i-fft)/cp) for i >= fft.
    (reference: src/acquire.c:322-342)
    """
    i = np.arange(fft + cp, dtype=np.float64)
    w = np.ones(fft + cp, dtype=np.float64)
    head = i < cp
    tail = i >= fft
    w[head] = np.sin(np.pi / 2 * i[head] / cp)
    w[tail] = np.cos(np.pi / 2 * (i[tail] - fft) / cp)
    return w.astype(np.float32)
