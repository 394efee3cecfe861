"""The specificity and envelope tools of the port
(breakmer_tpu_torch.tools.sweep_fp, tandem_floor, sweep_envelope_vaf) on
the CPU against the JAX tools of tools/, loaded by path: the same seeds
at each tool's smallest setting give records equal apart from wall
seconds. The VAF grid is cut to one cell, one boundary cell and two
kinds, in both modules; tandem_floor starts at seed 18, whose repeats
panel has a miss (TANDEM_FLOOR_r05.json), so the oracle runs."""

from tests.test_torch_tools_sweeps import records

from breakmer_tpu_torch.tools import sweep_envelope_vaf, sweep_fp, tandem_floor


def test_sweep_fp_equals_the_jax_tool(tmp_path):
    want, got = records("sweep_fp", sweep_fp,
                        ["--seeds", "1", "--start-seed", "3", "--profiles", "tuned"], tmp_path)
    assert got == want
    assert got["summary"]["tuned"]["regions"] == 12


def test_tandem_floor_equals_the_jax_tool(tmp_path):
    want, got = records("tandem_floor", tandem_floor,
                        ["--seeds", "1", "--start-seed", "18"], tmp_path)
    assert got == want
    assert got["misses"] >= 1 and got["planted_checked"] >= 4


def test_sweep_envelope_vaf_equals_the_jax_tool(tmp_path):
    def drop_walls(rec):
        for cell in rec["cells"] + rec["boundary_cells"]:
            cell.pop("wall_s")
        return rec

    want, got = records("sweep_envelope_vaf", sweep_envelope_vaf,
                        ["--seeds", "2", "--boundary-per-kind", "4"], tmp_path,
                        patch={"VAFS": [0.25], "DEPTHS": [100],
                               "BOUNDARY_CELLS": [(0.05, 100)], "SV_KINDS": ["ins", "trl"]})
    assert drop_walls(got) == drop_walls(want)
    assert got["boundary_events_per_kind"] == 4
    assert set(got["boundary_cells"][0]["per_kind"]) == {"ins", "trl"}
