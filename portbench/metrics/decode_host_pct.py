"""Share of the decode calls' wall in the decode driver's host spans:
``huff.decode.scan``, ``.tables``, ``.plans`` and ``.walk``.  From the
program's span timings over the traced run's window."""

HOST = ("huff.decode.scan", "huff.decode.tables", "huff.decode.plans",
        "huff.decode.walk")


def read(record):
    spans = record.get("spans")
    wall = sum(x["decode_s"] for x in record["passes"])
    if not spans or wall <= 0:
        return None
    return 100.0 * sum(spans.get(s, 0.0) for s in HOST) / wall
