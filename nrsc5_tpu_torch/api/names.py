"""Human-readable name tables for protocol codes (the port's copy of the
reference package's ``api/names.py``).

Mirrors the reference name helpers (reference: src/nrsc5.c:237-323,
include/nrsc5.h:205-319): program types (1020s table), service data types
and emergency-alert categories.
"""

from __future__ import annotations

PROGRAM_TYPES = {
    0: "None", 1: "News", 2: "Information", 3: "Sports", 4: "Talk",
    5: "Rock", 6: "Classic Rock", 7: "Adult Hits", 8: "Soft Rock",
    9: "Top 40", 10: "Country", 11: "Oldies", 12: "Soft", 13: "Nostalgia",
    14: "Jazz", 15: "Classical", 16: "Rhythm and Blues",
    17: "Soft Rhythm and Blues", 18: "Foreign Language",
    19: "Religious Music", 20: "Religious Talk", 21: "Personality",
    22: "Public", 23: "College", 24: "Spanish Talk", 25: "Spanish Music",
    26: "Hip-Hop", 29: "Weather", 30: "Emergency Test", 31: "Emergency",
    65: "Traffic", 76: "Special Reading Services",
}

SERVICE_DATA_TYPES = {
    0: "Non-specific", 1: "News", 3: "Sports", 29: "Weather",
    31: "Emergency", 65: "Traffic", 66: "Image Maps", 80: "Text",
    256: "Advertising", 257: "Financial", 258: "Stock Ticker",
    259: "Navigation", 260: "Electronic Program Guide", 261: "Audio",
    262: "Private Data Network", 263: "Service Maintenance",
    264: "HD Radio System Services", 265: "Audio-Related Objects",
    511: "Reserved for Special Tests",
}

ALERT_CATEGORIES = {
    1: "Non-specific", 2: "Geophysical", 3: "Weather", 4: "Safety",
    5: "Security", 6: "Rescue", 7: "Fire", 8: "Health", 9: "Environmental",
    10: "Transportation", 11: "Utilities", 12: "Hazmat", 30: "Test",
}


def program_type_name(code: int) -> str:
    return PROGRAM_TYPES.get(code, "Unknown")


def service_data_type_name(code: int) -> str:
    return SERVICE_DATA_TYPES.get(code, "Unknown")


def alert_category_name(code: int) -> str:
    return ALERT_CATEGORIES.get(code, "Unknown")
