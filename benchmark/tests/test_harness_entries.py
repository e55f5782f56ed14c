"""A configuration that brings its own entry and plain reference as added
files only: a tiny tree (`tiny.make_tree`) gains a configuration naming a
toy training harness, `entries/toy_train.py` and a workload, and the
harness runs it by name and judges it; a configuration naming no harness
gets the synthesis entry."""

import json

import pytest
import torch

from benchmark import run, spec
from benchmark.spec import ROOT
from benchmark.tests.tiny import make_tree

SEED = 2 ** 31 + 103

TOY_ENTRY = '''"""A toy training entry: SGD steps of a two-layer tanh network in
float64 on seeded regression rows, each step timed as one unit of work; one
step of the window, drawn from the seed, judged against a plain NumPy copy
of the step (its loss, and each leaf's gradient norm by the worst leaf)."""

import random
import time
from types import SimpleNamespace

import numpy as np
import torch
from torch.profiler import record_function

from benchmark import harness

LIMITS = {"loss_gap": 1e-9, "grad_gap": 1e-9, "failed": 0}


def plain_step(params, x, y):
    """The step's loss and gradients by hand: mean squared error of
    w2 tanh(w1 x + b1) + b2."""
    w1, b1, w2, b2 = params
    h = np.tanh(x @ w1.T + b1)
    r = h @ w2.T + b2 - y
    d_out = 2.0 * r / r.size
    d_h = (d_out @ w2) * (1.0 - h ** 2)
    return float(np.mean(r ** 2)), [d_h.T @ x, d_h.sum(0), d_out.T @ h, d_out.sum(0)]


def worst_leaf_gap(got, want):
    norms = [float(np.linalg.norm(w)) for w in want]
    floor = float(np.median(norms))
    return max(abs(float(np.linalg.norm(g)) - n) / max(n, floor) for g, n in zip(got, norms))


def run_cell(cell, seed, seconds, trace, device, t_start, keep=None):
    cfg, wl = cell.config, cell.workload
    dev = torch.device(device)
    gen = torch.Generator().manual_seed(seed)
    net = torch.nn.Sequential(torch.nn.Linear(cfg["in"], cfg["hidden"]), torch.nn.Tanh(),
                              torch.nn.Linear(cfg["hidden"], 1)).double()
    with torch.no_grad():
        for p in net.parameters():
            p.copy_(0.3 * torch.randn(p.shape, generator=gen, dtype=torch.float64))
    net.to(dev)
    opt = torch.optim.SGD(net.parameters(), lr=wl["lr"])
    batches = []
    for _ in range(wl["batches"]):
        x = torch.randn(wl["batch"], cfg["in"], generator=gen, dtype=torch.float64)
        batches.append((x.to(dev), torch.sin(x.sum(1, keepdim=True)).to(dev)))
    drawn = random.Random(seed).randrange(wl["check"]["within"])
    tracer = harness.Tracer(trace)
    run = SimpleNamespace(trace=None, steps=[])
    if keep is not None:
        keep["run"] = run
    kept = {}

    def step(i):
        x, y = batches[i % len(batches)]
        if i == drawn:
            kept["params"] = [p.detach().cpu().numpy().copy() for p in net.parameters()]
            kept["rows"] = (x.cpu().numpy(), y.cpu().numpy())
        opt.zero_grad()
        loss = torch.nn.functional.mse_loss(net(x), y)
        loss.backward()
        if i == drawn:
            kept["loss"] = float(loss.detach())
            kept["grads"] = [p.grad.cpu().numpy().copy() for p in net.parameters()]
        opt.step()

    t0 = time.monotonic()
    setup_s = time.perf_counter() - t_start
    end = t0 + seconds
    tracer.start_at = t0 + harness.TRACE_AT * seconds
    i = 0
    while time.monotonic() < end or i <= drawn:
        tracer.before()
        a = time.monotonic()
        with record_function(harness.CALL):
            step(i)
        b = time.monotonic()
        tracer.after(b)
        run.steps.append({"start": a, "done": b, "ok": True,
                          "audio_s": wl["batch"] * wl["clip_s"]})
        i += 1
    tracer.stop()
    run.trace = tracer.events()
    loss, grads = plain_step(kept["params"], *kept["rows"])
    numbers = {"loss_gap": abs(kept["loss"] - loss) / abs(loss),
               "grad_gap": worst_leaf_gap(kept["grads"], grads), "failed": 0}
    correct = all(numbers[k] <= LIMITS[k] for k in numbers)
    return harness.result(cell, trace, run, correct=correct, attempted=len(run.steps), failed=0,
                          e2e=dict(harness.end_to_end(run.steps, end, seconds), setup_s=setup_s),
                          dev=dev, peak=0, numbers=numbers, limits=LIMITS)
'''


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """The tiny tree with the toy configuration added as files and entries only."""
    where = make_tree(tmp_path_factory.mktemp("tree"))
    home = where / "bench"
    (home / "entries" / "toy_train.py").write_text(TOY_ENTRY)
    (home / "configs" / "toy.json").write_text(json.dumps(
        {"name": "toy", "harness": "toy_train", "in": 16, "hidden": 32}))
    (home / "workloads" / "toy.steps.json").write_text(json.dumps(
        {"batch": 8, "batches": 4, "lr": 0.05, "clip_s": 2.0, "check": {"within": 5}}))
    bench = json.loads((where / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "toy", "source": "a toy for the CPU tests",
                             "file": "bench/configs/toy.json", "reduced": [], "why": "CPU tests"})
    bench["workloads"].append({"name": "toy.steps", "config": "toy", "traffic": "steps",
                               "chips": 1, "why": "CPU tests"})
    (where / "BENCHMARK.json").write_text(json.dumps(bench))
    return where


def _run(root):
    return run.run_cell(spec.load("toy.steps", root), SEED, 0.3, False, device="cpu",
                        t_start=0.0)


def test_an_entry_of_added_files_runs_and_is_correct(root):
    cell = spec.load("toy.steps", root)
    assert cell.harness == "toy_train"
    assert spec.entry(cell.home, cell.harness).__code__.co_filename == \
        str(cell.home / "entries" / "toy_train.py")
    res = _run(root)
    assert res["correct"], res["checked"]
    assert res["attempted"] > 5 and res["failed"] == 0
    assert sorted(res["metrics"]) == sorted(m["name"] for m in cell.end_to_end)
    assert res["metrics"]["audio_s_per_s"]["value"] > 0
    assert list(res) == ["correct", "attempted", "failed", "metrics", "device", "checked"]
    json.dumps(res)


def test_an_altered_gradient_is_not_correct(root, monkeypatch):
    """A weight's gradient scaled by 1.01 where it is produced, its loss
    left exact: the plain copy's gradients tell."""

    class Scaled(torch.autograd.Function):
        @staticmethod
        def forward(ctx, w):
            return w.view_as(w)

        @staticmethod
        def backward(ctx, g):
            return g * 1.01

    linear = torch.nn.functional.linear
    monkeypatch.setattr(torch.nn.functional, "linear",
                        lambda x, w, b=None: linear(x, Scaled.apply(w), b))
    res = _run(root)
    assert not res["correct"], res["checked"]
    assert res["checked"]["loss_gap"]["value"] <= res["checked"]["loss_gap"]["limit"]
    assert res["checked"]["grad_gap"]["value"] > res["checked"]["grad_gap"]["limit"]


@pytest.mark.parametrize("cell", [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]] + ["tiny.poisson", "tiny-ms.voices"])
def test_a_configuration_naming_no_harness_gets_the_synthesis_entry(root, cell):
    c = spec.load(cell, root) if cell.startswith("tiny") else spec.load(cell)
    assert "harness" not in c.config and c.harness == "synthesis"
    assert spec.entry(c.home, c.harness).__code__.co_filename == \
        str(c.home / "entries" / "synthesis.py")
