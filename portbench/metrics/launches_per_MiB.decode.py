"""CUDA kernels launched per MiB of decode output in the traced pass, counted on
the profiler's device timeline (copies and memsets are not kernels)."""


def read(record):
    t = (record.get("trace") or {}).get("decode")
    if not t or not t.get("kernels") or not t.get("bytes_out"):
        return None
    return t["kernels"] / (t["bytes_out"] / 2**20)
