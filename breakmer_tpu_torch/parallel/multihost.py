"""Multi-host orchestration (BASELINE.json config #5).

Port of ``breakmer_tpu/parallel/multihost.py``. A panel run scales
across hosts as: one process per host, target regions partitioned
round-robin across processes (each with its own ledger shard for
region-granular resume), device-level work inside each process over its
local devices, and the call set merged by process 0 from the ledger
shards on the shared filesystem.

The JAX package's ``jax.distributed.initialize`` only tells each process
its index and the process count: no device collective ever crosses
processes. So the port's process group is a gloo rendezvous over TCP
(``init_distributed``), on a card machine as on the CPU, and carries
nothing after it; ``shutdown_distributed`` destroys it when the run ends.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

from breakmer_tpu_torch.utils.logging import get_logger

log = get_logger("multihost")


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> Tuple[int, int]:
    """Join the process group (a gloo rendezvous at
    ``tcp://coordinator_address``, process 0 holding its store) when
    configured for >1 process; returns (process_index, process_count).
    Safe to call single-process."""
    if num_processes and num_processes > 1:
        import torch.distributed as dist

        if not dist.is_initialized():
            dist.init_process_group(
                "gloo", init_method=f"tcp://{coordinator_address}",
                rank=process_id, world_size=num_processes,
            )
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def shutdown_distributed() -> None:
    """Destroy the process group, if one was joined, so that the process
    exits cleanly."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def partition_targets(
    names: Sequence[str], process_index: int, process_count: int
) -> List[str]:
    """Deterministic round-robin partition of target names — the
    multi-host analog of the reference pool handing regions to workers.
    Round-robin (not contiguous blocks) balances panels where neighboring
    genes have correlated read depth."""
    return [n for i, n in enumerate(names) if i % process_count == process_index]


def shard_ledger_path(analysis_dir: str | Path, process_index: int) -> Path:
    return Path(analysis_dir) / f"ledger_p{process_index}.json"


def merge_ledger_shards(
    analysis_dir: str | Path,
    target_order: Sequence[str],
    process_count: int,
    wait_timeout_s: float = 600.0,
    poll_s: float = 2.0,
) -> Dict[str, dict]:
    """Process 0: wait for every shard to be complete, merge to one
    ledger keyed in panel order. A shard is complete when it contains all
    the targets of its partition (each worker writes after every region,
    so partial shards are visible — completeness, not existence, is the
    barrier)."""
    deadline = time.time() + wait_timeout_s
    merged: Dict[str, dict] = {}
    for p in range(process_count):
        want = set(partition_targets(list(target_order), p, process_count))
        path = shard_ledger_path(analysis_dir, p)
        while True:
            have: Dict[str, dict] = {}
            if path.exists():
                try:
                    have = json.loads(path.read_text())
                except json.JSONDecodeError:
                    have = {}  # mid-write; retry
            # overlay the shard's append log (workers checkpoint regions
            # as O(1) JSONL appends; the snapshot only exists once a
            # worker finalizes — see Runner._append_ledger)
            ap = path.with_suffix(".jsonl")
            if ap.exists():
                for line in ap.read_text().splitlines():
                    if line.strip():
                        try:
                            rec = json.loads(line)
                        except json.JSONDecodeError:
                            continue  # torn tail line mid-write
                        have[rec["name"]] = rec["entry"]
            if want.issubset(have):
                merged.update({k: v for k, v in have.items() if k in want})
                break
            if time.time() > deadline:
                missing = sorted(want - set(have))
                log.warning(
                    "shard %d incomplete after %.0fs (missing %s) — "
                    "merging what exists",
                    p, wait_timeout_s, missing[:5],
                )
                merged.update({k: v for k, v in have.items() if k in want})
                break
            time.sleep(poll_s)
    return merged
