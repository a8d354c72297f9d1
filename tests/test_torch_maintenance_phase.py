"""`chip_smoke.py`'s step 23 (`maintenance_phase`) on the CPU, with the
kernels' plain versions: VACUUM on a small checkpointed headline log
(every file planted, retention 1 hour), then REORG PURGE, VACUUM, RESTORE
and CLONE on step 22's two tables at two links of each store_sales
fixture file. Every check of the step runs inside the phase: the deleted
sets against the generator's truth, the rows against step 22's numpy
models, the fixture files unchanged."""

import shutil

import chip_smoke
from delta_tpu_torch.utils.synth import synth_delta_log
from test_torch_wide_types import FIXTURES


def test_chip_maintenance_phase_passes_on_the_cpu(tmp_path):
    head = str(tmp_path / "headline")
    truth = synth_delta_log(head, 60, 20, checkpoint_version=50,
                            now_ms=chip_smoke.WEEK_MS)
    keep, kept, tables = {}, {}, {}
    chip_smoke.wide_types_phase(FIXTURES, "cpu", "cpu", links=2, keep=keep)
    chip_smoke.wide_write_phase(keep["all"], keep["nested"], FIXTURES,
                                "cpu", "cpu", links=2, keep=kept)
    try:
        chip_smoke.column_mapping_phase(kept, "cpu", "cpu", keep=tables)
        chip_smoke.write_modes_phase(tables, "cpu", "cpu")
        out = chip_smoke.maintenance_phase(head, truth, tables,
                                           str(tmp_path), "cpu", "cpu",
                                           plant_every=1)
    finally:
        shutil.rmtree(kept["work"], ignore_errors=True)
    assert list(out["steps"]) == [
        "vacuum_full_dry", "vacuum_lite_dry", "vacuum_full",
        "vacuum_lite_again", "reorg_purge", "purge_read_all", "vacuum_dry",
        "vacuum_lite", "vacuum_full_dry_after", "vacuum_reload",
        "vacuum_read_all", "restore", "restore_read_all", "restore_vacuum",
        "restore_vacuum_read_all", "restore_refused", "clone_shallow",
        "shallow_read", "shallow_vacuum", "clone_deep", "deep_read"]
    assert out["planted"]["tombstones"] == truth.num_tombstones
    assert out["steps"]["reorg_purge"]["files_removed"] > 0
    assert out["a_vacuum"]["lite"] > 0 and out["b_restore"]["vacuumed"] > 0
    assert set(out["vacuum_phase_s"]["vacuum_full"]) == {
        "load", "protected", "walk", "select", "unlink", "watermark"}
