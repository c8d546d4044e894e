"""Share of the bytes the encode copied back from the card that its
stream holds: ``stream_bytes`` over ``encode_d2h_bytes`` (``encode.COUNTS``,
over the traced run's window)."""


def read(record):
    c = record.get("counts") or {}
    if not c.get("encode_d2h_bytes") or "stream_bytes" not in c:
        return None
    return 100.0 * c["stream_bytes"] / c["encode_d2h_bytes"]
