"""Share of the bytes the decode copied back from the card that its output
takes: ``device_out_bytes`` over ``decode_d2h_bytes`` (``decode.COUNTS``,
over the traced run's window)."""


def read(record):
    c = record.get("counts") or {}
    if not c.get("decode_d2h_bytes") or "device_out_bytes" not in c:
        return None
    return 100.0 * c["device_out_bytes"] / c["decode_d2h_bytes"]
