"""100 x (1 - the union of the device's kernel, copy and memset intervals
over the traced window's length), from the profiler's trace."""


def read(record):
    t = record["trace"]
    if not t or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
