"""A run's samples, made and written as BAM files in a process of their own,
so that the generator's memory never counts in the peak resident memory of
the process that runs the program. On a checkout's first run it also builds
the genome cache. The parent writes the plan and reads back the result:

    python3 -m svbench.prepare <work>/plan.json

writes ``<work>/prepared.pkl``: the genome cache's directory, the samples
(their truth, with their reads left in the BAM files) and the generation's
seconds.
"""

from __future__ import annotations

import json
import pickle
import sys
import time
from pathlib import Path

from svbench import harness
from svbench.gen.genome import Genome, GenomeSpec, make_panel
from svbench.gen.sample import SampleMaker


def main(plan_path: str) -> int:
    plan = json.loads(Path(plan_path).read_text())
    cfg, work = plan["cfg"], Path(plan["work"])
    genome = Genome(GenomeSpec.from_config(cfg["genome"]))
    panel = make_panel(genome, cfg["panel"])
    genome_dir = harness.ensure_genome(genome, Path(plan["bed"]), plan["device"])
    t0 = time.perf_counter()
    prepared = harness.prepare_samples(SampleMaker(genome, panel, cfg, plan["mix"]), genome, int(plan["seed"]),
                                       work, int(cfg["samples_per_run"]))
    gen_s = time.perf_counter() - t0
    with open(work / "prepared.pkl", "wb") as fh:
        pickle.dump({"genome_dir": str(genome_dir), "prepared": prepared, "gen_s": gen_s}, fh)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
