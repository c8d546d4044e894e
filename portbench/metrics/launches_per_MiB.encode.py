"""CUDA kernels launched per MiB of encode input in the traced pass, counted on
the profiler's device timeline (copies and memsets are not kernels)."""


def read(record):
    t = (record.get("trace") or {}).get("encode")
    if not t or not t.get("kernels") or not t.get("bytes_in"):
        return None
    return t["kernels"] / (t["bytes_in"] / 2**20)
