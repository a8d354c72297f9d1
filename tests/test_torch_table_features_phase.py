"""`chip_smoke.py`'s step 24 (`table_features_phase`) on the CPU, with the
kernels' plain versions: type widening, MERGE's schema evolution, CHECK
constraints and a table with identity, generated and default columns, on
step 22's tables at two links of each store_sales fixture file (step 23,
which the card runs in between, is left out here for the time). Every
check of the step runs inside the phase: the rows against step 22's
numpy models, the identity values and watermarks, the generated and
default values against numpy's."""

import shutil

import chip_smoke
from test_torch_wide_types import FIXTURES


def test_chip_table_features_phase_passes_on_the_cpu(tmp_path):
    keep, kept, tables = {}, {}, {}
    chip_smoke.wide_types_phase(FIXTURES, "cpu", "cpu", links=2, keep=keep)
    chip_smoke.wide_write_phase(keep["all"], keep["nested"], FIXTURES,
                                "cpu", "cpu", links=2, keep=kept)
    try:
        chip_smoke.column_mapping_phase(kept, "cpu", "cpu", keep=tables)
        chip_smoke.write_modes_phase(tables, "cpu", "cpu")
        out = chip_smoke.table_features_phase(tables, kept["step19"],
                                              str(tmp_path), "cpu", "cpu")
    finally:
        shutil.rmtree(kept["work"], ignore_errors=True)
    assert list(out["steps"]) == [
        "set_widening", "widen_ss_quantity", "widen_ss_sales_price",
        "append_big", "read_at_old_bound", "read_past_2_31", "zorder",
        "checkpoint", "reload", "read_all", "merge_evolve", "delete_big",
        "constraint_refused", "add_constraint", "append_refused",
        "update_refused", "drop_constraint", "read_after", "fresh_write",
        "fresh_append_0", "fresh_append_1", "fresh_merge", "fresh_read"]
    assert out["steps"]["zorder"]["files_removed"] > 0
    assert out["fresh"]["commits"] == 4
    assert out["fresh"]["rows"] > 2 * sum(chip_smoke.TF_FRESH_APPENDS)
