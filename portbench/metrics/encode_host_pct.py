"""Share of the encode calls' wall that the host spends outside the
program's device and copy-back spans: in ``huff.encode.assemble`` and
under no ``huff.encode.*`` span at all (batch building, the final join).
From the program's span timings over the traced run's window."""


def read(record):
    spans = record.get("spans")
    wall = sum(x["encode_s"] for x in record["passes"])
    if not spans or wall <= 0:
        return None
    device = spans.get("huff.encode.device", 0.0) + spans.get(
        "huff.encode.d2h", 0.0)
    return 100.0 * (wall - device) / wall
