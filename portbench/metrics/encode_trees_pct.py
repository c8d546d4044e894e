"""Share of the encode calls' wall that the host spends in the tree build,
``huff.encode.trees`` (``build_trees`` and ``extract_codes``: enqueuing
their rounds, and the one wait for the round count).  From the program's
span timings over the traced run's window."""


def read(record):
    spans = record.get("spans") or {}
    wall = sum(x["encode_s"] for x in record["passes"])
    if "huff.encode.trees" not in spans or wall <= 0:
        return None
    return 100.0 * spans["huff.encode.trees"] / wall
