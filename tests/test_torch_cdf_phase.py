"""`chip_smoke.py`'s step 25 (`change_data_feed_phase`) on the CPU, with
the kernels' plain versions: the change data feed on the tables steps
22-24 leave, at two links of each store_sales fixture file (step 23 on a
small checkpointed headline log, every file planted). Every check of the
step runs inside the phase: each version's change data against the
numpy models, the change data files' form, the timestamps and the
timestamp bounds, the refused range, RESTORE's feed."""

import shutil

import chip_smoke
from delta_tpu_torch.utils.synth import synth_delta_log
from test_torch_wide_types import FIXTURES


def test_chip_change_data_feed_phase_passes_on_the_cpu(tmp_path):
    head = str(tmp_path / "headline")
    truth = synth_delta_log(head, 30, 10, checkpoint_version=20,
                            now_ms=chip_smoke.WEEK_MS)
    keep, kept, tables = {}, {}, {}
    chip_smoke.wide_types_phase(FIXTURES, "cpu", "cpu", links=2, keep=keep)
    chip_smoke.wide_write_phase(keep["all"], keep["nested"], FIXTURES,
                                "cpu", "cpu", links=2, keep=kept)
    try:
        chip_smoke.column_mapping_phase(kept, "cpu", "cpu", keep=tables)
        chip_smoke.write_modes_phase(tables, "cpu", "cpu")
        chip_smoke.maintenance_phase(head, truth, tables, str(tmp_path),
                                     "cpu", "cpu", plant_every=1)
        chip_smoke.table_features_phase(tables, kept["step19"],
                                        str(tmp_path), "cpu", "cpu")
        out = chip_smoke.change_data_feed_phase(tables, "cpu", "cpu")
    finally:
        shutil.rmtree(kept["work"], ignore_errors=True)
    assert list(out["steps"]) == [
        "a_set_cdf", "a_delete", "a_update", "a_merge", "a_feed",
        "a_feed_by_time", "a_feed_missing", "a_restore", "a_restore_feed",
        "b_set_cdf", "b_append", "b_delete_partition", "b_merge", "b_feed"]
    assert out["a_feed"]["rows"] > 0 and out["b_feed"]["cdc_files"] > 0
    assert out["a_restore"]["deletes"] > 0
    assert out["a_restore"]["inserts"] > 0
