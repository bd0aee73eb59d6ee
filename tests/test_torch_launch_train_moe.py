"""The port's sharded train step against the reference's (see
``test_torch_launch_train.py``) for the hybrid and MoE kinds, f32, 2x4:

* reduced hymba-1.5b: attention and SSD heads in one layer (4 attention
  heads over model 4 with K/V whole; 8 SSD heads, 2 a rank);
* reduced deepseek-moe-16b: expert parallelism (16 padded experts, 4 a
  rank) and the router's aux loss, which must be the global batch's (its
  sums and row count summed over the data axis).

Each with ZeRO-1 on and off, labels of -1 in data rank 0's rows.  Loss
and grad norm within 1e-5 relative, params and moments within 1e-4
absolute."""
import pytest

pytest.importorskip("torch")

import torch_launch_parity as lp  # noqa: E402

REL, ABS = 1e-5, 1e-4
CASES = [
    dict(tag="hymba-z1", arch="hymba-1.5b", zero1=True),
    dict(tag="hymba", arch="hymba-1.5b", zero1=False),
    dict(tag="deepseek-z1", arch="deepseek-moe-16b", zero1=True),
    dict(tag="deepseek", arch="deepseek-moe-16b", zero1=False),
]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return lp.run_train(CASES, tmp_path_factory.mktemp("launch_train_moe"))


@pytest.mark.parametrize("tag", [c["tag"] for c in CASES])
def test_train_step_matches_reference(runs, tag):
    lp.check_train_step(runs, tag, REL, ABS)
