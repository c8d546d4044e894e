"""Share of the encode calls' wall that the host spends building the
batches (``huff.encode.batch``) and joining their bytes
(``huff.encode.join``).  From the program's span timings over the traced
run's window."""

SPANS = ("huff.encode.batch", "huff.encode.join")


def read(record):
    spans = record.get("spans") or {}
    wall = sum(x["encode_s"] for x in record["passes"])
    if any(s not in spans for s in SPANS) or wall <= 0:
        return None
    return 100.0 * sum(spans[s] for s in SPANS) / wall
