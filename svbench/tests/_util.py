"""Shared set-up of the benchmark's CPU tests."""

import json
from pathlib import Path

from svbench import harness
from svbench.gen.genome import Genome, GenomeSpec, make_panel
from svbench.gen.sample import SampleMaker

PKG = Path(harness.__file__).resolve().parent


def maker(config: str, mix: str, targets: int = 4) -> SampleMaker:
    cfg = harness.rehearsal_config(json.loads((PKG / "configs" / f"{config}.json").read_text()))
    cfg["panel"]["targets"] = targets
    mx = json.loads((PKG / "traffic" / f"{mix}.json").read_text())
    g = Genome(GenomeSpec.from_config(cfg["genome"]))
    return SampleMaker(g, make_panel(g, cfg["panel"]), cfg, mx)


def cell(config: str, mix: str) -> dict:
    return {"name": f"{config}.{mix}", "config": config, "traffic": mix, "chips": 1}
