"""The JAX package's ``tools/`` ported to the card, each run as
``python -m breakmer_tpu_torch.tools.<name>``:

  - the four TPU probes, each with a hand-written CUDA kernel (``csrc/``)
    beside its plain torch version;
  - the SW agreement check (``gpu_agreement``), the accuracy sweeps, the
    panel scaling sweep, the genome-scale and ingest benches and the
    fetch probe, which run the port's Runner and kernels on ``--device``
    (``cuda`` by default; ``cpu`` runs the plain versions).

A tool that writes a record defaults to ``build/tools/<the JAX tool's
file name>`` (``default_out``), never to a record committed in the repo.
"""

from __future__ import annotations

import json
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
OUT_DIR = REPO / "build" / "tools"


def default_out(name: str) -> str:
    """Where a tool writes ``name`` unless given ``--out``: under the
    checkout's gitignored ``build/tools/``."""
    return str(OUT_DIR / name)


def write_json(path, obj) -> None:
    """``obj`` as indented JSON to ``path``, its directory made first."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(obj, indent=2) + "\n")
