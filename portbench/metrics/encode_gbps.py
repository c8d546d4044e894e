"""Encode throughput: input bytes of every encode call in the window over
the summed wall time of those calls (each returns host bytes, so it ends
synchronised with the card)."""


def read(record):
    p = record["passes"]
    t = sum(x["encode_s"] for x in p)
    return sum(x["bytes"] for x in p) / t / 1e9 if t > 0 else None
