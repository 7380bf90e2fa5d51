"""Reed-Solomon RS(255,247) codec over GF(2^8), batched in numpy.

NRSC-5 protects each audio-PDU header with a shortened RS(96,88) slice of
RS(255,247): gfpoly 0x11d, fcr=1, prim=1, 8 parity symbols (reference:
src/rs_init.c:63-81, src/frame.c:158-179, src/frame.h:5-8).  The PDU's first
8 bytes are the parity, bytes 8..95 the protected data, and the whole
96-byte codeword is bit-reversed into the tail of a 255-byte block whose
leading 159 bytes must decode to zero.

The decoder is syndrome -> inversionless Berlekamp-Massey -> Chien -> Forney,
written batched over codewords (the per-frame count is small, but the
multi-station pipeline pushes thousands of codewords per second through
here).  Implemented from the textbook algorithm — not a port of the
reference's Karn codec; correctness is established by encode/corrupt/decode
roundtrip tests across all error weights.
"""

from __future__ import annotations

import functools

import numpy as np

from nrsc5_tpu_torch import constants as C

NN = 255
NROOTS = C.RS_PARITY_LEN  # 8
T2 = NROOTS


@functools.lru_cache(maxsize=1)
def _gf_tables():
    """exp/log tables for GF(256) with primitive poly 0x11d."""
    exp = np.zeros(512, dtype=np.int32)
    log = np.zeros(256, dtype=np.int32)
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= C.RS_GFPOLY
    exp[255:510] = exp[0:255]
    log[0] = -511  # sentinel: any product involving 0 indexes exp far negative
    return exp, log


def _gf_mul(a, b):
    """Elementwise GF multiply for uint8/int arrays (0-safe)."""
    exp, log = _gf_tables()
    a = np.asarray(a, dtype=np.int32)
    b = np.asarray(b, dtype=np.int32)
    prod = exp[np.maximum(log[a] + log[b], 0)]
    return np.where((a == 0) | (b == 0), 0, prod).astype(np.uint8)


@functools.lru_cache(maxsize=1)
def _genpoly() -> np.ndarray:
    """Generator polynomial prod_{i=1}^{8}(x - alpha^i), low degree first."""
    exp, _ = _gf_tables()
    g = np.array([1], dtype=np.uint8)
    for i in range(1, NROOTS + 1):
        root = np.uint8(exp[i])
        nxt = np.zeros(len(g) + 1, dtype=np.uint8)
        nxt[1:] ^= g  # g * x
        nxt[:-1] ^= _gf_mul(g, root)
        g = nxt
    return g[::-1].copy()  # high degree first: g[0] = 1


def rs_encode_pdu(data88: np.ndarray) -> np.ndarray:
    """Encode PDU header data (…, 88 bytes = PDU bytes 8..95) into the full
    96-byte codeword prefix [parity(8) | data(88)] as transmitted."""
    was_1d = np.asarray(data88).ndim == 1
    data88 = np.atleast_2d(np.asarray(data88, dtype=np.uint8))
    b = data88.shape[0]
    # message polynomial: hdr[159..246] = buf[95..8]  (degree 95-j for buf[j])
    # c(x) = m(x) * x^8 + rem;  compute remainder by synthetic division
    g = _genpoly()  # degree 8, g[0]=1
    msg = data88[:, ::-1]  # hdr order: coefficient of x^(95-?) ... high first
    rem = np.zeros((b, NROOTS), dtype=np.uint8)
    for j in range(msg.shape[1]):
        feedback = rem[:, 0] ^ msg[:, j]
        rem[:, :-1] = rem[:, 1:]
        rem[:, -1] = 0
        rem ^= _gf_mul(feedback[:, None], g[1:][None, :])
    # hdr[247..254] = parity (high degree first) = buf[7..0]
    parity = rem[:, ::-1]  # buf[0..7]
    out = np.concatenate([parity, data88], axis=1)
    return out[0] if was_1d else out


def rs_decode_pdu(buf96: np.ndarray):
    """Decode shortened codewords.

    buf96: [..., 96] uint8 PDU prefixes (parity first, as received).
    Returns (corrected [..., 96] uint8, ok [...] bool, n_corrected [...] int).
    Failure (>4 errors) leaves the data unchanged with ok=False.

    Dispatches to the native C++ decoder when available (the transport
    thread decodes one PDU at a time, where per-call numpy overhead
    dominates); the batched numpy path below is the tested spec and the
    fallback.
    """
    from nrsc5_tpu_torch import native

    res = native.rs_decode_pdu(buf96)
    if res is not None:
        return res
    return rs_decode_pdu_numpy(buf96)


def rs_decode_pdu_numpy(buf96: np.ndarray):
    """Batched numpy reference implementation (see rs_decode_pdu)."""
    exp, log = _gf_tables()
    orig_shape = buf96.shape
    buf = np.asarray(buf96, dtype=np.uint8).reshape(-1, 96)
    b = buf.shape[0]

    # Build full coefficient array c, degree 254 down to 0.
    # hdr[j] = coefficient of x^(254-j); hdr[159+i] = buf[95-i].
    cw = np.zeros((b, NN), dtype=np.uint8)
    cw[:, 159:] = buf[:, ::-1]

    # Syndromes S_i = c(alpha^(i+1)), i = 0..7.  Only the 96 nonzero
    # coefficients matter: coefficient of x^d at d = 0..95.
    d = np.arange(96, dtype=np.int64)  # buf[j] has degree j
    powers = exp[(d[None, :] * np.arange(1, NROOTS + 1)[:, None]) % 255]
    # S[i] = XOR_j gf_mul(buf[j], alpha^((i+1)*j))
    syn = np.zeros((b, NROOTS), dtype=np.uint8)
    for i in range(NROOTS):
        terms = _gf_mul(buf, powers[i][None, :])
        syn[:, i] = np.bitwise_xor.reduce(terms, axis=1)

    no_err = ~syn.any(axis=1)

    # Inversionless Berlekamp-Massey, batched with masks.
    lam = np.zeros((b, NROOTS + 1), dtype=np.uint8)
    lam[:, 0] = 1
    prev = lam.copy()  # b(x), pre-multiplied by x each iteration
    bc = np.ones(b, dtype=np.uint8)
    ll = np.zeros(b, dtype=np.int64)
    for n in range(T2):
        # discrepancy d_n = sum_i lam[i] * S[n-i]
        disc = np.zeros(b, dtype=np.uint8)
        for i in range(min(n, NROOTS) + 1):
            disc ^= _gf_mul(lam[:, i], syn[:, n - i])
        xb = np.roll(prev, 1, axis=1)
        xb[:, 0] = 0
        t = _gf_mul(bc[:, None], lam) ^ _gf_mul(disc[:, None], xb)
        cond = (disc != 0) & (2 * ll <= n)
        prev = np.where(cond[:, None], lam, xb)
        bc = np.where(cond, disc, bc)
        ll = np.where(cond, n + 1 - ll, ll)
        lam = t

    # Chien search over the 96 valid positions (errors elsewhere = failure).
    # Error locators X_k = alpha^{pos}; lam(X^-1) = 0 at error positions.
    pos = np.arange(96, dtype=np.int64)
    inv_pow = exp[(255 - pos[:, None] * np.arange(NROOTS + 1)[None, :]) % 255]
    # lam_eval[b, pos] = XOR_i gf_mul(lam[b,i], alpha^{-pos*i})
    lam_eval = np.zeros((b, 96), dtype=np.uint8)
    for i in range(NROOTS + 1):
        lam_eval ^= _gf_mul(lam[:, i][:, None], inv_pow[:, i][None, :])
    is_root = lam_eval == 0
    nroots_found = is_root.sum(axis=1)

    # also count roots over the full field to detect out-of-range errors
    pos_full = np.arange(NN, dtype=np.int64)
    inv_pow_f = exp[(255 - pos_full[:, None] * np.arange(NROOTS + 1)[None, :]) % 255]
    lam_eval_f = np.zeros((b, NN), dtype=np.uint8)
    for i in range(NROOTS + 1):
        lam_eval_f ^= _gf_mul(lam[:, i][:, None], inv_pow_f[:, i][None, :])
    nroots_full = (lam_eval_f == 0).sum(axis=1)

    deg_lam = np.where(lam.any(axis=1),
                       NROOTS - np.argmax(lam[:, ::-1] != 0, axis=1), 0)
    ok = no_err | ((nroots_full == deg_lam) & (nroots_found == deg_lam)
                   & (deg_lam <= NROOTS // 2) & (deg_lam > 0))

    # Forney: omega(x) = S(x)*lam(x) mod x^8;
    # e_pos = omega(X^-1) / lam'(X^-1)   (fcr = 1)
    omega = np.zeros((b, NROOTS), dtype=np.uint8)
    for i in range(NROOTS):
        acc = np.zeros(b, dtype=np.uint8)
        for j in range(i + 1):
            if i - j <= NROOTS:
                acc ^= _gf_mul(lam[:, j], syn[:, i - j])
        omega[:, i] = acc
    # lam'(x): derivative keeps odd-power terms: lam'[i] = lam[i+1]*(i+1 mod 2)
    # in GF(2): d/dx sum a_i x^i = sum_{i odd} a_i x^(i-1)
    omega_eval = np.zeros((b, 96), dtype=np.uint8)
    for i in range(NROOTS):
        omega_eval ^= _gf_mul(omega[:, i][:, None], inv_pow[:, i][None, :])
    lamp_eval = np.zeros((b, 96), dtype=np.uint8)
    for i in range(1, NROOTS + 1, 2):
        lamp_eval ^= _gf_mul(lam[:, i][:, None], inv_pow[:, i - 1][None, :])
    # err = omega_eval / lamp_eval  (where is_root)
    inv_lamp = exp[(255 - log[np.maximum(lamp_eval, 1)]) % 255].astype(np.uint8)
    err = _gf_mul(omega_eval, inv_lamp)
    err = np.where(is_root & (lamp_eval != 0), err, 0)

    corrected = buf ^ np.where(ok[:, None] & ~no_err[:, None], err, 0)
    n_corr = np.where(ok, np.where(no_err, 0, deg_lam), 0)
    return (corrected.reshape(orig_shape), ok.reshape(orig_shape[:-1]),
            n_corr.reshape(orig_shape[:-1]))
