"""Share of the traced decode call's wall in which the card ran no kernel and
no copy (the profiler's device timeline)."""


def read(record):
    t = (record.get("trace") or {}).get("decode")
    if not t or not t.get("wall_s") or not t.get("busy_s"):
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["wall_s"])
