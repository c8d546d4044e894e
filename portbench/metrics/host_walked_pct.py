"""Share of the decoded blocks that the host walked instead of the device
(``decode.COUNTS``), over the traced run's window."""


def read(record):
    c = record.get("counts")
    if not c:
        return None
    total = c["host_decoded_blocks"] + c["device_decoded_blocks"]
    return 100.0 * c["host_decoded_blocks"] / total if total else None
