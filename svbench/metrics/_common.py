"""What the metric readers share: the window's regions and its METER
stage seconds, summed over the samples it ran."""

from typing import Optional

STAGES = ("bam_decode", "extract_clean", "kmer_device", "assemble", "realign", "classify")


def regions(record: dict) -> int:
    return sum(p["completed"] for p in record["passes"])


def stage_s(record: dict, *names: str) -> float:
    return sum(p["stage_s"].get(n, 0.0) for p in record["passes"] for n in names)


def per_region_ms(record: dict, *names: str) -> Optional[float]:
    n = regions(record)
    return 1000.0 * stage_s(record, *names) / n if n else None
