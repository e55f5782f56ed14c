"""The control of the comparison that decides `correct`, on a card: the
reference with TF32 on in the program's place must read not correct,
where the program's own answers read correct. Skips without CUDA."""

import pytest
import torch

from benchmark import run, spec
from benchmark.tests.tiny import make_tree


@pytest.fixture(scope="module")
def cuda_root(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return make_tree(tmp_path_factory.mktemp("tree"))


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["tiny.poisson", "tiny.single"])
def test_the_tf32_control_is_not_correct(cuda_root, name):
    cell = spec.load(name, cuda_root)
    entry = spec.entry(cell.home, cell.harness)
    for seed in (11, 12, 13):
        assert run.run_cell(cell, seed, 3.0, False, t_start=0.0)["correct"]
        res = entry(cell, seed, 3.0, False, "cuda", 0.0, control=True)
        assert not res["correct"], res["checked"]
