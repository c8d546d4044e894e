"""Share of the decode calls' wall in the host walk of the blocks that the
device route left out: the ``huff.decode.host_walk`` spans, which lie inside
``huff.decode.walk``.  From the program's span timings over the traced
run's window.  A window that walks no block opens no such span and reads 0;
a program that does not count the walked bytes (``host_walked_bytes`` in
``decode.COUNTS``) has no such span either, and reads None."""

SPAN = "huff.decode.host_walk"


def read(record):
    spans = record.get("spans")
    counts = record.get("counts") or {}
    wall = sum(x["decode_s"] for x in record["passes"])
    if not spans or "host_walked_bytes" not in counts or wall <= 0:
        return None
    return 100.0 * spans.get(SPAN, 0.0) / wall
