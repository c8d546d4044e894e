"""Share of the decode output that the host walk produced instead of the
device: ``host_walked_bytes`` over ``host_walked_bytes + device_out_bytes``
(``decode.COUNTS``, over the traced run's window).  None where the program
does not count the walked bytes."""


def read(record):
    c = record.get("counts") or {}
    if "host_walked_bytes" not in c or "device_out_bytes" not in c:
        return None
    total = c["host_walked_bytes"] + c["device_out_bytes"]
    return 100.0 * c["host_walked_bytes"] / total if total else None
