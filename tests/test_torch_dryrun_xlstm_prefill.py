"""The xLSTM-1.3B prefill_32k cell of the dry run on ``meta``, in a file of
its own (its sLSTM layer traces 32768 per-token steps): one period of
depth (7 mLSTM and 1 sLSTM layer) at full width on the (16, 16) mesh's
last rank, as ``test_torch_dryrun_xlstm.py`` runs the other xLSTM cells.
"""
from test_torch_dryrun_cells import check_cell_runs


def test_xlstm_prefill_step_runs_on_meta():
    check_cell_runs("xlstm-1.3b", "prefill_32k")
