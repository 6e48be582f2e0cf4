"""The xLSTM-1.3B cells of the dry run on ``meta`` but its prefill
(``test_torch_dryrun_cells.py`` has the other archs,
``test_torch_dryrun_xlstm_prefill.py`` the prefill): one period of depth
(7 mLSTM and 1 sLSTM layer) at full width on the (16, 16) mesh's last
rank.  The sLSTM layer runs one step a token, as on the card, which makes
these the slowest cells to trace.
"""
import pytest

from test_torch_dryrun_cells import check_cell_runs


@pytest.mark.parametrize("shape", ["train_4k", "decode_32k", "long_500k"])
def test_xlstm_cell_step_runs_on_meta(shape):
    check_cell_runs("xlstm-1.3b", shape)
