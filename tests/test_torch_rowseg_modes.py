"""The port's tile form in every mode and class at open >, = and < ext,
against the one-shot sweep.

``score_rowseg_plain`` chained in superstep order (``run_tiles`` of
``test_torch_rowseg.py``) over 1, 3 and 4 column shards and row chunks of
8, 24 and 36 rows, on ragged batches with empty sides, queries that end
above, inside and on a tile's last row and references that end on a
shard's edge, must equal
``score_align_plain`` exactly: NW, the nine semi-global free-end sets,
semi-global with no free end and SW, for the score, stats and trace
classes.
"""

import pytest

torch = pytest.importorskip("torch")

from parasail_rs_tpu_torch.ops import scan_kernel as tk  # noqa: E402

from test_torch_rowseg import (  # noqa: E402
    MODES,
    one_shot,
    run_tiles,
    tiles_case,
)
from test_torch_segment import CLASSES, PENALTIES, same  # noqa: E402


@pytest.mark.parametrize("outputs", CLASSES)
@pytest.mark.parametrize("open_,ext", PENALTIES,
                         ids=[f"{a}_{b}" for a, b in PENALTIES])
@pytest.mark.parametrize("name", sorted(MODES))
def test_plain_tiles_match_one_shot(name, open_, ext, outputs):
    # empty sides, queries ending above, inside and on a tile's last row
    mode, free = MODES[name]
    case = tiles_case(5 * open_ + ext + len(name))
    kw = dict(open_=open_, ext=ext, mode=mode, free=free, outputs=outputs,
              width="sat")
    D, qc = ((3, 24), (4, 36), (1, 8))[(len(name) + open_ +
                                        CLASSES.index(outputs)) % 3]
    got, _ = run_tiles(tk.score_rowseg_plain, case, D, qc, kw)
    same(got, one_shot(case, kw), f"{name} {outputs} D {D} q_chunk {qc}")
