"""The port's example notebooks (`examples/torch/*.ipynb`), the counterparts
of `examples/*.ipynb` (`tests/test_notebooks.py`): every code cell runs top
to bottom on the CPU with STYLETTS2_DEMO_LITE=1 STYLETTS2_DEMO_DEVICE=cpu,
and no cell imports JAX, the JAX package, PyYAML or transformers (the
card's machine has none of them).

The LJSpeech notebook is marked slow: its random-init utterances run
35-60 s of audio through the full-width iSTFTNet decoder (LITE shrinks
only PL-BERT and the denoiser, as the JAX notebook's does), ~6 minutes on
one CPU thread. The other two run in tier 1 on 4 threads. On the card
`chip_smoke.py` runs all three at full width.
"""

import ast
import json
import os
import shutil
from pathlib import Path

import pytest
import torch

NB_DIR = Path(__file__).resolve().parent.parent / "examples" / "torch"
NOTEBOOKS = ("demo_ljspeech.ipynb", "demo_libritts.ipynb", "finetune_demo.ipynb")
BANNED = ("jax", "jaxlib", "flax", "yaml", "transformers", "styletts2_tpu")


def code_cells(name):
    with open(NB_DIR / name) as f:
        nb = json.load(f)
    return [(i, "".join(c["source"])) for i, c in enumerate(nb["cells"])
            if c["cell_type"] == "code"]


def run_notebook(name, tmp_path, monkeypatch):
    monkeypatch.setenv("STYLETTS2_DEMO_LITE", "1")
    monkeypatch.setenv("STYLETTS2_DEMO_DEVICE", "cpu")
    monkeypatch.chdir(tmp_path)
    threads = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        ns = {}
        for i, src in code_cells(name):
            exec(compile(src, f"{name}:cell{i}", "exec"), ns)
    finally:
        torch.set_num_threads(threads)
    return ns


def test_notebooks_are_the_jax_ones_ported():
    """Three notebooks, each with as many code cells as its JAX counterpart,
    each markdown cell naming the JAX notebook it mirrors."""
    for name in NOTEBOOKS:
        with open(NB_DIR / name) as f:
            port = json.load(f)
        with open(NB_DIR.parent / name) as f:
            jax_nb = json.load(f)
        kinds = [c["cell_type"] for c in port["cells"]]
        assert kinds == [c["cell_type"] for c in jax_nb["cells"]], name
        for c in port["cells"]:
            if c["cell_type"] == "markdown":
                assert f"examples/{name}" in "".join(c["source"]), name


@pytest.mark.parametrize("name", NOTEBOOKS)
def test_no_cell_imports_jax_yaml_or_transformers(name):
    for i, src in code_cells(name):
        for node in ast.walk(ast.parse(src)):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for mod in mods:
                assert mod.split(".")[0] not in BANNED, f"{name} cell {i} imports {mod}"


@pytest.mark.slow
def test_demo_ljspeech_notebook(tmp_path, monkeypatch):
    ns = run_notebook("demo_ljspeech.ipynb", tmp_path, monkeypatch)
    assert os.path.getsize(tmp_path / "demo_lj.wav") > 44 and len(ns["wavs"]) == 3


def test_demo_libritts_notebook(tmp_path, monkeypatch):
    ns = run_notebook("demo_libritts.ipynb", tmp_path, monkeypatch)
    assert ns["ref_s"].shape == (1, 256) and len(ns["wavs"]) == 3
    assert os.path.getsize(tmp_path / "demo_libritts.wav") > 44


def test_finetune_notebook(tmp_path, monkeypatch):
    try:
        ns = run_notebook("finetune_demo.ipynb", tmp_path, monkeypatch)
        logs = set(os.listdir(tmp_path / "ft_demo_data" / "logs"))
        assert ns["state"].epoch == 1 and {"epoch_ft_00001.pth", "finetune_final.pth"} <= logs
    finally:  # two checkpoints of the full-width trainer with its optimizers: ~3.8 GB
        shutil.rmtree(tmp_path / "ft_demo_data", ignore_errors=True)
