"""Decode throughput: output bytes of every decode call in the window over
the summed wall time of those calls."""


def read(record):
    p = record["passes"]
    t = sum(x["decode_s"] for x in p)
    return sum(x["decode_bytes"] for x in p) / t / 1e9 if t > 0 else None
