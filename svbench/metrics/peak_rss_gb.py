"""The run's peak resident host memory (VmHWM at the window's close), in GB."""


def read(record):
    return record["peak_rss_bytes"] / 1e9 if record["peak_rss_bytes"] else None
