"""Share of the bytes bound that the encode's kernels reach in the traced
pass: the problem's bytes (input bytes read once and stream bytes
written once) at the card's peak memory bandwidth,
over the summed device time of every kernel the call launched (copies
excluded).  It counts the problem's bytes, not the implementation's
intermediates, so a fused or moved stage is read against the same count."""


def read(record):
    t = (record.get("trace") or {}).get("encode")
    peak = record.get("peak_bytes_per_s")
    if not t or not peak or not t.get("kernel_s") or "bytes_in" not in t:
        return None
    bound_s = (t["bytes_in"] + t["bytes_out"]) / peak
    return 100.0 * bound_s / t["kernel_s"]
