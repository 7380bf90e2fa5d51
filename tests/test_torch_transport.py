"""The port's copies of the host transport (events, CRCs, Reed-Solomon,
the native host ops, frame parse, ID3, HERE images, output, PIDS/SIS and
the transport and SIS encoders) against the reference package's modules,
on the same seeded inputs.  Host code only: numpy and bytes, exact.

Events are compared by the reference's own key (tests/test_serve.py
``_ev_key``: the type, then every payload field, arrays as bytes)."""

import numpy as np
import pytest

from nrsc5_tpu import constants as JC
from nrsc5_tpu import native as JN
from nrsc5_tpu.api import events as JE
from nrsc5_tpu.ops import rs as JRS
from nrsc5_tpu.transport import frame as JTF
from nrsc5_tpu.transport import here_images as JHI
from nrsc5_tpu.transport import id3 as JID3
from nrsc5_tpu.transport import output as JOUT
from nrsc5_tpu.transport import pids as JP
from nrsc5_tpu.tx import sis_encoder as JSIS
from nrsc5_tpu.tx import transport_encoder as JTE
from nrsc5_tpu.utils import crc as JCRC
from nrsc5_tpu_torch import constants as C
from nrsc5_tpu_torch import native as TN
from nrsc5_tpu_torch.api import events as TE
from nrsc5_tpu_torch.ops import rs as TRS
from nrsc5_tpu_torch.transport import frame as TTF
from nrsc5_tpu_torch.transport import here_images as THI
from nrsc5_tpu_torch.transport import id3 as TID3
from nrsc5_tpu_torch.transport import output as TOUT
from nrsc5_tpu_torch.transport import pids as TP
from nrsc5_tpu_torch.tx import sis_encoder as TSIS
from nrsc5_tpu_torch.tx import transport_encoder as TTE
from nrsc5_tpu_torch.utils import crc as TCRC

from .test_serve import _ev_key, _id3
from .test_transport import _here_packet, aas_packet, lot_fragment, sig_table


def _keys(events):
    """Event keys, with the event types by name (the two packages' enums
    are distinct classes of the same members)."""
    return [(k[0].name,) + k[1:] for k in map(_ev_key, events)]


def test_event_types_equal():
    """The event, AAS and MIME enums hold the reference's members and
    values, and ``make`` builds the same payloads."""
    for name in ("EventType", "AASType", "MIMEType"):
        j, t = getattr(JE, name), getattr(TE, name)
        assert [(m.name, m.value) for m in j] == [(m.name, m.value)
                                                  for m in t]
    kw = {"title": "x", "artist": "y"}
    assert _keys([JE.make(JE.EventType.ID3, **kw)]) == _keys(
        [TE.make(TE.EventType.ID3, **kw)])


def test_crcs_equal(rng):
    """CRC-8, FCS-16, CRC-12 and the two alert CRCs on random inputs."""
    for n in (1, 7, 96, 333):
        data = rng.integers(0, 256, n).astype(np.uint8).tobytes()
        assert TCRC.crc8(data) == JCRC.crc8(data)
        assert TCRC.fcs16(data) == JCRC.fcs16(data)
        assert TCRC.fcs16_append(data) == JCRC.fcs16_append(data)
        assert TCRC.alert_cnt_crc(data) == JCRC.alert_cnt_crc(data)
        assert TCRC.alert_crc7(data) == JCRC.alert_crc7(data)
    for _ in range(8):
        bits = rng.integers(0, 2, 80).astype(np.uint8)
        assert TCRC.crc12(bits) == JCRC.crc12(bits)
        np.testing.assert_array_equal(TCRC.crc12_embed(bits[:68]),
                                      JCRC.crc12_embed(bits[:68]))


@pytest.mark.parametrize("n_errors", [0, 4, 5])
def test_rs_decode_equal(rng, n_errors):
    """RS(96,88) PDU headers with 0, 4 (the correction limit) and 5 (one
    past it) byte errors: the encoders agree and both decoders (numpy
    paths) give the same words, flags and counts."""
    data = rng.integers(0, 256, (6, 88)).astype(np.uint8)
    code = np.stack([TRS.rs_encode_pdu(d) for d in data])
    np.testing.assert_array_equal(
        code, np.stack([JRS.rs_encode_pdu(d) for d in data]))
    for row in code:
        pos = rng.choice(96, n_errors, replace=False)
        row[pos] ^= rng.integers(1, 256, n_errors).astype(np.uint8)
    got = TRS.rs_decode_pdu_numpy(code)
    want = JRS.rs_decode_pdu_numpy(code)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert bool(got[1].all()) == (n_errors <= 4)


def test_native_source_is_the_reference():
    """The port builds the reference's host C++ as it is."""
    from pathlib import Path
    src = Path(TN.__file__).with_name("host_ops.cpp").read_bytes()
    assert src == Path(JN.__file__).with_name("host_ops.cpp").read_bytes()


def test_native_matches_python(rng):
    """The port's native library against the pure-Python paths (the
    reference's own check, tests/test_transport.py:109): CRC-8, the AAS
    frame filter, the gather-pack and the RS decode."""
    if TN.get_lib() is None:
        pytest.skip("no host C++ compiler builds the native library")
    for n in (1, 50, 499):
        data = rng.integers(0, 256, n).astype(np.uint8).tobytes()
        assert TN.crc8(data) == TCRC.crc8(data)
    inner = b"\x21" + bytes(rng.integers(0, 256, 100).astype(np.uint8))
    framed = TTE.hdlc_escape(TCRC.fcs16_append(inner))
    assert TN.aas_frame(framed) == inner[1:]
    bad = bytearray(framed)
    bad[5] ^= 0xFF
    assert TN.aas_frame(bytes(bad)) is None
    bits = rng.integers(0, 2, 4000).astype(np.uint8)
    idx = rng.permutation(4000)[:1003].astype(np.int32)
    np.testing.assert_array_equal(TN.gather_pack(bits, idx),
                                  np.packbits(bits[idx]))
    code = np.stack([TRS.rs_encode_pdu(d) for d in
                     rng.integers(0, 256, (5, 88)).astype(np.uint8)])
    code[1, [3, 40, 77]] ^= 0x5A
    code[3, [0, 9, 18, 27, 36]] ^= 0x11
    for a, b in zip(TN.rs_decode_pdu(code), TRS.rs_decode_pdu_numpy(code)):
        np.testing.assert_array_equal(a, b)


def _p1_frames(enc, rng, n_frames, psd, lead=0):
    packets = [rng.integers(0, 256, 280).astype(np.uint8).tobytes()
               for _ in range(n_frames * 32)]
    return [enc.build_p1_fm_frame(packets[f * 32:(f + 1) * 32], 0,
                                  (f + lead) % 8, ((f + lead) * 32) % 64,
                                  psd=psd)
            for f in range(n_frames)]


@pytest.mark.parametrize("flips", [0, 12, 400])
def test_frame_parse_equal(flips):
    """Four P1 frames of HDC packets with an ID3 title in the AAS PSD,
    built by both transport encoders (the same bits), parsed by both
    frame decoders into both outputs: the same events, with 0, 12 (the RS
    headers correct them) and 400 random bit flips a frame."""
    rng = np.random.default_rng(11)
    psd = TTE.aas_frame(0x5100, 0, _id3("Transport Twin"))
    assert psd == JTE.aas_frame(0x5100, 0, _id3("Transport Twin"))
    frames = _p1_frames(TTE, np.random.default_rng(3), 4, psd)
    for a, b in zip(frames, _p1_frames(JTE, np.random.default_rng(3), 4,
                                       psd)):
        np.testing.assert_array_equal(a, b)
    events = {}
    for name, out_mod, tf, lc in (("jax", JOUT, JTF, JTF.P1),
                                  ("torch", TOUT, TTF, TTF.P1)):
        got = events[name] = []
        out = out_mod.Output(got.append, mode_fm=True)
        dec = tf.FrameDecoder(out)
        flip_rng = np.random.default_rng(7)
        for fr in frames:
            fr = fr.copy()
            pos = flip_rng.choice(fr.size, flips, replace=False)
            fr[pos] ^= 1
            dec.push_frame(fr, lc)
            for _ in range(C.P1_FM_BLOCKS):
                out.advance()
    assert _keys(events["torch"]) == _keys(events["jax"])
    if not flips:
        kinds = {e.type.name for e in events["torch"]}
        assert {"HDC", "ID3"} <= kinds


def test_output_aas_equal(rng):
    """SIG, LOT (out of order, a duplicate) and an unknown port through
    both outputs: the same events."""
    content = rng.integers(0, 256, 700).astype(np.uint8).tobytes()
    frags = [content[i * 256:(i + 1) * 256] for i in range(3)]
    pushes = [aas_packet(0x20, 0, sig_table()),
              aas_packet(0x1001, 0, lot_fragment(7, 2, frags[2])),
              aas_packet(0x1001, 1, lot_fragment(7, 0, frags[0],
                                                 name="map.png",
                                                 size=len(content))),
              aas_packet(0x1001, 2, lot_fragment(7, 2, frags[2])),
              aas_packet(0x1001, 3, lot_fragment(7, 1, frags[1])),
              aas_packet(0x4444, 0, b"\x00" * 32)]
    events = {}
    for name, mod in (("jax", JOUT), ("torch", TOUT)):
        got = events[name] = []
        out = mod.Output(got.append)
        for p in pushes:
            out.aas_push(p)
    assert _keys(events["torch"]) == _keys(events["jax"])
    assert "LOT" in {e.type.name for e in events["torch"]}


def test_id3_and_here_images_equal(rng):
    """ID3 tags (title, artist, album, a commercial frame) parse the same;
    HERE image streams (split, resynced over garbage, re-sent, after a
    sequence gap) give the same events."""
    def frame(fid, body):
        return fid + len(body).to_bytes(4, "big") + b"\x00\x00" + body
    body = (frame(b"TIT2", b"\x00Title") + frame(b"TPE1", b"\x00Artist")
            + frame(b"TALB", b"\x01\xff\xfeA\x00l\x00b\x00")
            + frame(b"COMR", b"\x00USD1.00\x0020201231\x00url\x00\x01"
                    b"Seller\x00desc\x00"))
    n = len(body)
    tag = b"ID3\x03\x00\x00" + bytes([(n >> 21) & 0x7F, (n >> 14) & 0x7F,
                                      (n >> 7) & 0x7F, n & 0x7F]) + body
    assert TID3.parse_id3(tag) == JID3.parse_id3(tag)
    assert TID3.parse_id3(tag[:20]) == JID3.parse_id3(tag[:20])
    data = rng.integers(0, 256, 500).astype(np.uint8).tobytes()
    pkt = _here_packet(8, 3, 12345, "tile3.png", data)
    stream = b"\xab" * 7 + pkt
    pushes = [(10, stream[:40]), (11, stream[40:]), (12, pkt),
              (50, pkt[:30]), (99, pkt),
              (100, _here_packet(8, 3, 99999, "tile3.png", data[:77]))]
    events = {}
    for name, mod in (("jax", JHI), ("torch", THI)):
        got = events[name] = []
        hi = mod.HereImages(got.append)
        for seq, chunk in pushes:
            hi.push(seq, chunk)
    assert _keys(events["torch"]) == _keys(events["jax"])
    assert len(events["torch"]) == 2


def _sis_frames(mod):
    frames = [mod.station_id("US", 12345), mod.short_name("KQED-FM"),
              mod.audio_service(0, type_=1), mod.parameter(3, 77),
              mod.local_time(-480, 1, True)]
    frames += mod.location(37.5, -122.25, 100)
    frames += mod.long_name("A Long Station Name Of The Port")
    frames += mod.message("Hello from the twin test", priority=1)
    frames += mod.emergency_alert("Tornado warning for the area",
                                  category1=2)
    return frames


def test_sis_encode_and_decode_equal():
    """The SIS encoders build the same PIDS words; both PIDS decoders give
    the same events on them, a corrupted word included."""
    jw, tw = _sis_frames(JSIS), _sis_frames(TSIS)
    assert len(jw) == len(tw)
    for a, b in zip(jw, tw):
        np.testing.assert_array_equal(a, b)
    bad = tw[1].copy()
    bad[5] ^= 1
    events = {}
    for name, mod in (("jax", JP), ("torch", TP)):
        got = events[name] = []
        dec = mod.PIDSDecoder(got.append)
        for w in tw + [bad] + tw[:3]:
            dec.frame_push(w)
    assert _keys(events["torch"]) == _keys(events["jax"])
    kinds = {e.type.name for e in events["torch"]}
    assert {"STATION_ID", "STATION_NAME", "SIS"} <= kinds


def test_constants_used_by_the_transport_equal():
    """The constants the copied transport reads are the reference's."""
    for name in ("P1_FRAME_LEN_FM", "P1_FM_BLOCKS", "MAX_PROGRAMS",
                 "MAX_STREAMS", "PCI_AUDIO", "P3_FRAME_LEN_MP3_MP11"):
        assert getattr(C, name) == getattr(JC, name), name
