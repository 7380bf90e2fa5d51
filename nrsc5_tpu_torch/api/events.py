"""Public event types — the framework's observable surface.

Mirrors the reference event API (reference: include/nrsc5.h:162-613 and the
Python binding support/nrsc5.py:196-236): one callback, 31 event kinds, with
Python dataclass payloads instead of a C union.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field


class EventType(enum.IntEnum):
    LOST_DEVICE = 0
    IQ = 1
    SYNC = 2
    LOST_SYNC = 3
    MER = 4
    BER = 5
    HDC = 6
    AUDIO = 7
    ID3 = 8
    SIG = 9
    LOT = 10
    SIS = 11
    STREAM = 12
    PACKET = 13
    AUDIO_SERVICE = 14
    STATION_ID = 15
    STATION_NAME = 16
    STATION_SLOGAN = 17
    STATION_MESSAGE = 18
    STATION_LOCATION = 19
    AUDIO_SERVICE_DESCRIPTOR = 20
    DATA_SERVICE_DESCRIPTOR = 21
    EMERGENCY_ALERT = 22
    HERE_IMAGE = 23
    LOT_HEADER = 24
    LOT_FRAGMENT = 25
    AGC = 26
    EXCITER_INFO = 27
    IMPORTER_INFO = 28
    LEAP_SECOND_OFFSET = 29
    LOCAL_TIME = 30


class ServiceType(enum.IntEnum):
    AUDIO = 0
    DATA = 1


class ComponentType(enum.IntEnum):
    AUDIO = 0
    DATA = 1


class MIMEType(enum.IntEnum):
    PRIMARY_IMAGE = 0xBE4B7536
    STATION_LOGO = 0xD9C72536
    NAVTEQ = 0x2D42AC3E
    HERE_TPEG = 0x82F03DFC
    HERE_IMAGE = 0xB7F03DFC
    HD_TMC = 0xEECB55B6
    HDC = 0x4DC66C5A
    TEXT = 0xBB492AAC
    JPEG = 0x1E653E9C
    PNG = 0x4F328CA0
    TTN_TPEG_1 = 0xB39EBEB2
    TTN_TPEG_2 = 0x4EB03469
    TTN_TPEG_3 = 0x52103469
    TTN_STM_TRAFFIC = 0xFF8422D7
    TTN_STM_WEATHER = 0xEF042E96
    UNKNOWN_00000000 = 0x00000000
    UNKNOWN_B81FFAA8 = 0xB81FFAA8
    UNKNOWN_FFFFFFFF = 0xFFFFFFFF


class AASType(enum.IntEnum):
    STREAM = 0
    PACKET = 1
    LOT = 3


@dataclass
class Event:
    type: EventType
    payload: dict = field(default_factory=dict)

    def __getattr__(self, name):
        # payload keys read as attributes (so e.data works for HDC events
        # even though the dataclass field is named `payload`)
        try:
            return self.payload[name]
        except KeyError as e:
            raise AttributeError(name) from e


def make(type_: EventType, **kw) -> Event:
    return Event(type_, kw)
