"""The port's step meters (`styletts2_tpu_torch/observability.py`, after
`styletts2_tpu/observability.py:109-156`) and the trainer's debug-NaN path
(`train/run.py`, after the JAX `run.py:246-262`): `StepTimer`'s EMA,
`nan_check` naming the non-finite leaves of nested metrics and tensors,
`trace` writing a Chrome trace on the CPU, and `run_stage` under
STYLETTS2_DEBUG_NAN=1 stopping at the first non-finite step and naming
the poisoned parameter (STYLETTS2_TRACE_STEP=1 tracing that step).
"""

import json
import logging
import math
import os

import numpy as np
import pytest
import torch

from styletts2_tpu_torch import observability as obs
from styletts2_tpu_torch.config import Config
from styletts2_tpu_torch.train import run
from torch_tiny_train import small_aux_builders


def test_step_timer_ema(monkeypatch):
    clock = iter([0.0, 1.0, 10.0, 13.0, 20.0, 20.5])
    monkeypatch.setattr(obs.time, "perf_counter", lambda: next(clock))
    timer = obs.StepTimer(ema=0.9)
    assert timer.avg is None
    got = []
    for _ in range(3):
        timer.start()
        got.append(timer.stop())
    assert got == [1.0, 3.0, 0.5]
    assert timer.avg == pytest.approx(0.9 * (0.9 * 1.0 + 0.1 * 3.0) + 0.1 * 0.5)


def test_nan_check_names_the_bad_leaves(caplog):
    logger = logging.getLogger("test_torch_observability")
    tree = {"mel": 0.5, "grads": {"decoder": [torch.ones(3), torch.tensor([1.0, math.nan])],
                                  "wd": torch.zeros(2)},
            "steps": (np.float32(2.0), np.array([np.inf]))}
    with caplog.at_level(logging.ERROR, logger="test_torch_observability"):
        assert not obs.nan_check(tree, logger)
    assert "['grads']['decoder'][1]" in caplog.text and "['steps'][1]" in caplog.text
    assert "['wd']" not in caplog.text
    assert obs.nan_check({"a": [torch.ones(2)], "b": 3.0, "c": None})


def test_device_busy_ms_is_the_union_of_device_intervals():
    ev = [{"cat": "kernel", "ts": 0.0, "dur": 1000.0},  # 0-1 ms
          {"cat": "kernel", "ts": 500.0, "dur": 1000.0},  # 0.5-1.5 ms, another stream
          {"cat": "gpu_memcpy", "ts": 2000.0, "dur": 250.0},
          {"cat": "gpu_memset", "ts": 2100.0, "dur": 50.0},  # inside the copy
          {"cat": "gpu_user_annotation", "ts": 0.0, "dur": 9000.0},  # a span, not work
          {"cat": "cuda_runtime", "ts": 3000.0, "dur": 700.0},  # the host
          {"ph": "M", "name": "process_name"}]
    assert obs.device_busy_ms(ev) == pytest.approx(1.75)
    assert obs.device_busy_ms([]) == 0.0


def test_trace_writes_a_chrome_trace(tmp_path):
    with obs.trace(str(tmp_path / "traces")) as prof:
        torch.relu(torch.randn(64, 64) @ torch.randn(64, 64))
    assert prof is not None
    files = list((tmp_path / "traces").iterdir())
    assert len(files) == 1 and files[0].suffix == ".json"
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("aten::mm" in e.get("name", "") for e in events)
    with obs.trace(str(tmp_path / "off"), enabled=False) as prof:
        pass
    assert prof is None and not (tmp_path / "off").exists()


def test_debug_nan_names_the_poisoned_parameter(tmp_path, monkeypatch):
    from test_torch_train_run import TINY, _fixture

    data, log_dir = tmp_path / "data", tmp_path / "logs"
    data.mkdir()
    _fixture(data)
    cfg = Config.from_dict({
        "log_dir": str(log_dir), "epochs_1st": 1, "batch_size": 2, "max_len": 80,
        "log_interval": 1,
        "data_params": {"train_data": str(data / "train.txt"), "val_data": str(data / "val.txt"),
                        "root_path": str(data), "OOD_data": str(data / "ood.txt"),
                        "min_length": 10},
        "model_params": dict(TINY, slm={"hidden": 48, "nlayers": 3})})
    start = run.start

    def poisoned_start(stage, cfg, state, logger):
        start(stage, cfg, state, logger)
        with torch.no_grad():
            state.models["text_encoder"].embedding.weight[3, 0] = math.nan

    monkeypatch.setattr(run, "start", poisoned_start)
    monkeypatch.setenv("STYLETTS2_DEBUG_NAN", "1")
    monkeypatch.setenv("STYLETTS2_TRACE_STEP", "1")
    with small_aux_builders(), pytest.raises(FloatingPointError, match="STYLETTS2_DEBUG_NAN"):
        run.run_stage("first", cfg, max_steps=1, device="cpu")
    log = (log_dir / "train.log").read_text()
    assert "non-finite values in: " in log
    bad = log.split("non-finite parameters: ", 1)[1].splitlines()[0]
    assert "'text_encoder.embedding.weight'" in bad and len(eval(bad)) <= 20
    assert len(os.listdir(log_dir / "traces")) == 1  # the traced first step
