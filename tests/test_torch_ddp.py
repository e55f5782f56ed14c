"""Data parallelism over processes (`styletts2_tpu_torch/parallel/ddp.py`) on
the CPU: two gloo processes (`torch.multiprocessing.spawn`, a rendezvous
file in tmp_path) at tests/torch_tiny_train.py's tiny widths.

- A stage-1 TMA step and a stage-2 joint step on two ranks, each holding 4
  utterances of unequal lengths (their waves and texts of other lengths
  than the other rank's), compute what one process computes on the 8
  concatenated (computed beside them, a process per stage). Each rank
  draws from its own stream (`ddp.rank_seed`), so the comparison makes
  every draw the same for every row (`rows_alike_draws`), and TPRLS's
  median pick its element on rounded values (`stable_median`). Every logged
  loss within 1e-5 relative, the averaged gradient of every stepped module
  at every optimizer step within 1e-3 of its norm (stage 2's SLM pass and
  WavLM-discriminator step, which see the generator step's weights, within
  LATE_GRAD_REL), and the parameters after the step within 1e-6 absolute
  (Adam's first step moves a weight by about lr times the sign of its
  gradient, so a gradient within rounding of 0 moves it either way: such
  weights, within 2 lr per step, are counted and held to 1e-3 of all; the
  modules the late steps move are held to LATE_GRAD_REL of their update;
  the spectral-norm vectors to 1e-6 throughout). Measured here: losses
  <= 9.3e-7, gradients <= 1.8e-5 (the late steps' 7.9e-3, their modules'
  updates 1.9e-2), 6939 of 54.4M (stage 1) and 1487 of 55.6M (stage 2)
  weights past 1e-6. The ranks' parameters, spectral-norm vectors and
  metrics are bit-equal.
- `run.main` under two ranks (the variables torch.distributed.run sets):
  one step, the log naming the backend, and only rank 0 writing into the
  log directory.
- `process_shard` equals the JAX package's `parallel/mesh.py:process_shard`
  (its process count and index patched) for 0..50 items over 1..8
  processes, and a batch that does not divide over the ranks raises.
"""

import builtins
import contextlib
import dataclasses
import json
import os
import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
import torch.nn.functional as F

import styletts2_tpu_torch.models.decoder_istft as pdi
from styletts2_tpu_torch.parallel import ddp
from styletts2_tpu_torch.train import stage1 as pstage1
from styletts2_tpu_torch.train import stage2 as pstage2
from torch_tiny_train import run_step, small_aux_builders, tiny_batch, tiny_cfg, tiny_models

WORLD = 2
STAGES = ("first", "second")
# GRAD_REL: scaling the weights by 1 + 1e-7 N(0, 1) moves a random-init
# generator step's gradients by up to 2.5e-5 of their norm (the style
# encoder's, measured here), and a batch split rounds otherwise by as much
LOSS_REL, GRAD_REL, PARAM_ABS, FLIP_SHARE = 1e-5, 1e-3, 1e-6, 1e-3
# Stage 2's SLM pass and WavLM-discriminator step run on the weights the
# generator step moved, where a few weights moved by Adam's sign of a
# gradient within rounding of 0 (FLIP_SHARE); and at random init the pass's
# gradients of PL-BERT, its projection and the predictor are ill-conditioned:
# scaling those weights by 1 + 1e-7 N(0, 1) moves them by 2.3e-2 of their
# norm, and with the moved weights the two ranks' SLM-pass gradients differ
# from one process's by up to 7.9e-3 (measured here); their losses stay
# within LOSS_REL
LATE_GRAD_REL = 1e-1
MEDIAN_GRID = 1e-4  # stable_median's rounding: ~1e3 times a discriminator output's ulp


def _case(stage):
    """(trainer class, config, modules, epoch) of the step; the decoder's
    head gain scaled by 0.1, as tests/test_torch_stage1.py scales it, to
    keep the random-init iSTFT head's exp in f32's range."""
    cfg = tiny_cfg()
    if stage == "first":
        cfg.loss_params.TMA_epoch = 0
        models = tiny_models(cfg)
    else:
        cfg.loss_params.diff_epoch, cfg.loss_params.joint_epoch, cfg.slmadv_params.iter = 0, 0, 1
        models = tiny_models(cfg, "second")
    with torch.no_grad():
        models["decoder"].generator.conv_post.weight_g.mul_(0.1)
    trainer = pstage1.Stage1Trainer if stage == "first" else pstage2.Stage2Trainer
    return trainer, cfg, models, 0


@contextlib.contextmanager
def rows_alike_draws():
    """Every draw of the step the same for every row, whatever the batch:
    torch.rand / randn drawn over a shape's trailing axes and repeated over
    its first, randint and dropout's mask so too, the k-th draw from seed k (the draws kept, not zeroed: with no noise the HiFi-GAN
    source is constant and the AdaINs of its noise branch normalise
    rounding). A rank then draws what one process draws on the global
    batch, which the ranks' own streams (`ddp.rank_seed`) do not."""
    saved, count = (torch.rand, torch.randn, torch.randint, F.dropout), [0]

    def fixed():  # the step's k-th draw from seed k, on every rank alike
        count[0] += 1
        return torch.Generator().manual_seed(count[0])

    def alike(fn):
        def draw(size, generator=None, device=None, dtype=None):
            size = tuple(size)
            return fn(size[1:], generator=fixed(), dtype=dtype).expand(size).clone().to(device)
        return draw

    def randint(low, high, size, generator=None, device=None):
        return saved[2](low, high, size, generator=fixed()).to(device)

    def dropout(x, p=0.5, training=True, inplace=False):
        if not training or p == 0.0:
            return x
        keep = (saved[0](x.shape[1:], generator=fixed()) >= p).to(x.dtype)
        return x * (keep / (1.0 - p)).to(x.device)

    torch.rand, torch.randn, torch.randint, F.dropout = (alike(saved[0]), alike(saved[1]), randint,
                                                         dropout)
    try:
        yield
    finally:
        torch.rand, torch.randn, torch.randint, F.dropout = saved


@contextlib.contextmanager
def stable_median():
    """torch.median(x) as the element of x at the lower median of x rounded
    to MEDIAN_GRID. TPRLS (`losses.tprls_loss`) sends its gradient through
    the lower median's element; among the ~1e5 outputs of a discriminator
    the middle two lie ~1e-6 apart, at times within rounding of each other,
    and then a batch split rounds them into the other order: the loss
    agrees, but the discriminator's or the generator's gradient moves by
    ~0.2 of its norm. On the rounded values both pick the same element."""
    median = torch.median

    def rounded(x, *a, **k):
        if a or k:
            return median(x, *a, **k)
        flat = x.reshape(-1)
        return flat[median(torch.round(flat.detach() / MEDIAN_GRID), dim=0).indices]

    torch.median = rounded
    try:
        yield
    finally:
        torch.median = median


@contextlib.contextmanager
def stable_har_phase():
    """The NSF source's STFT phase zeroed (tests/torch_parity.py: its ~0
    bins' atan2 flips under any reassociation, and a batch of 4 rounds
    otherwise than a batch of 8; a random-init decoder amplifies that to
    O(1))."""
    magphase = pdi.stft_magphase

    def zero_phase(*a):
        mag, phase = magphase(*a)
        return mag, torch.zeros_like(phase)

    pdi.stft_magphase = zero_phase
    try:
        yield
    finally:
        pdi.stft_magphase = magphase


def _global_batch():
    """8 utterances of unequal lengths; rank 0's texts are shorter than rank
    1's, so each rank's batch pads its tokens otherwise (`_shard`)."""
    b = tiny_batch(2 * 4, seed=5)
    b.tokens[:4, 10:] = 0
    b.input_lengths[:4] = np.minimum(b.input_lengths[:4], 10)
    return b


def _shard(batch, r):
    """Rank r's 4 rows, its tokens padded to its own longest text, as the
    loader pads a batch."""
    rows = slice(4 * r, 4 * (r + 1))
    out = {f.name: getattr(batch, f.name)[rows] for f in dataclasses.fields(batch)}
    out["tokens"] = out["tokens"][:, :int(out["input_lengths"].max())]
    return dataclasses.replace(batch, **out)


def _state(state):
    return {f"{k}.{n}": v.detach().clone() for k, m in state.models.items()
            for n, v in m.state_dict().items()}


def _step(stage, batch):
    trainer_cls, cfg, models, epoch = _case(stage)
    with stable_har_phase(), rows_alike_draws(), stable_median():
        metrics, grads, state = run_step(trainer_cls, cfg, models, batch, epoch)
    return {"metrics": ddp.mean_metrics(metrics), "grads": grads, "state": _state(state)}


def _step_worker(r, init_file, out_dir):
    torch.set_num_threads(1)
    if r >= WORLD:  # the reference: one process on the global batch, a process per stage
        stage = STAGES[r - WORLD]
        torch.save(_step(stage, _global_batch()), os.path.join(out_dir, f"one_{stage}.pt"))
        return
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=r, world_size=WORLD)
    try:
        torch.save({s: _step(s, _shard(_global_batch(), r)) for s in STAGES},
                   os.path.join(out_dir, f"rank{r}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both stages' steps on the two ranks and, beside them in a process
    per stage, on one: ([rank 0's, rank 1's], one process's), each
    {stage: {"metrics", "grads", "state"}}."""
    d = tmp_path_factory.mktemp("ddp")
    mp.spawn(_step_worker, args=(str(d / "rdv"), str(d)), nprocs=WORLD + len(STAGES))
    load = lambda name: torch.load(d / name, weights_only=False)  # noqa: E731
    return [load(f"rank{r}.pt") for r in range(WORLD)], {s: load(f"one_{s}.pt") for s in STAGES}


@pytest.mark.parametrize("stage", STAGES)
def test_two_ranks_step_as_one_process_on_the_global_batch(stage, runs):
    ranks, one = runs
    check_as_one_process(stage, [r[stage] for r in ranks], one[stage])


def check_as_one_process(stage, ranks, want):
    """The ranks' step ({"metrics", "grads", "state"} each, full tensors)
    against one process's, `want` (the tolerances above); returns the
    gradients' errors {(optimizer step, module): relative L2}."""
    got = ranks[0]
    for other in ranks[1:]:  # every rank holds the same weights, vectors and metrics
        assert other["metrics"] == got["metrics"]
        assert all(torch.equal(other["state"][k], v) for k, v in got["state"].items())
    assert sorted(got["metrics"]) == sorted(want["metrics"])
    loss_err = {k: abs(got["metrics"][k] - v) / max(abs(v), 1e-6)
                for k, v in want["metrics"].items()}
    assert max(loss_err.values()) <= LOSS_REL, loss_err
    assert [sorted(s) for s in got["grads"]] == [sorted(s) for s in want["grads"]]
    # stage 2's optimizer steps: D, G, the SLM pass, wd (the last two late)
    late = 2 if stage == "second" else len(want["grads"])
    grad_err = {(i, k): float((a[k] - b[k]).norm()) / max(float(b[k].norm()), 1e-30)
                for i, (a, b) in enumerate(zip(got["grads"], want["grads"])) for k in b}
    for (i, k), err in grad_err.items():
        assert err <= (LATE_GRAD_REL if i >= late else GRAD_REL), (i, k, err)
    _, cfg, models, _ = _case(stage)
    op = cfg.optimizer_params
    lr, flips, total, late_keys = max(op.lr, op.bert_lr, op.ft_lr), 0, 0, set()
    for s in want["grads"][late:]:
        late_keys |= set(s)
    buffers = {f"{k}.{n}" for k, m in models.items() for n, _ in m.named_buffers()}
    before = {f"{k}.{n}": v for k, m in models.items() for n, v in m.state_dict().items()}
    moves = {k: [0.0, 0.0] for k in late_keys}  # |update difference|^2, |update|^2
    for name, w in want["state"].items():
        if not w.is_floating_point():
            continue
        key = name.split(".")[0]
        diff = (got["state"][name] - w).abs()
        n_steps = sum(key in s for s in want["grads"])
        # an Adam step from fresh moments moves a weight by at most its lr: a
        # flipped one differs by at most twice that, per step of the module
        assert float(diff.max()) <= 2 * n_steps * lr + PARAM_ABS, name
        if name in buffers:  # the spectral-norm vectors, the frozen statistics
            assert float(diff.max()) <= PARAM_ABS, name
        if key in late_keys:
            moves[key][0] += float((diff ** 2).sum())
            moves[key][1] += float(((w - before[name]) ** 2).sum())
            continue
        flips += int((diff > PARAM_ABS).sum())
        total += w.numel()
    assert flips <= FLIP_SHARE * total, (flips, total)
    late_err = {k: (d / u) ** 0.5 for k, (d, u) in moves.items()}
    assert all(e <= LATE_GRAD_REL for e in late_err.values()), late_err
    print(f"{stage}: losses within {max(loss_err.values()):.1e}; gradients "
          f"{max(e for (i, _), e in grad_err.items() if i < late):.1e}, late "
          f"{max([e for (i, _), e in grad_err.items() if i >= late], default=0):.1e}; "
          f"{flips} of {total} weights past {PARAM_ABS:g}; late modules' updates "
          f"{max(late_err.values(), default=0):.1e}")
    return grad_err


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_worker(r, port, cfg_path, out_dir):
    torch.set_num_threads(1)
    os.environ.update(RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(WORLD),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    from styletts2_tpu_torch.train import run

    log_dir = json.loads(open(cfg_path).read())["log_dir"]
    written, real_open, real_save = [], builtins.open, torch.save

    def record(path):
        if str(os.path.abspath(path)).startswith(os.path.abspath(log_dir)):
            written.append(os.path.basename(path))

    def open_(path, mode="r", *a, **k):
        if any(c in mode for c in "wax+") and isinstance(path, (str, os.PathLike)):
            record(path)
        return real_open(path, mode, *a, **k)

    def save(obj, f, *a, **k):
        if isinstance(f, (str, os.PathLike)):
            record(f)
        return real_save(obj, f, *a, **k)

    builtins.open, torch.save = open_, save
    try:
        with small_aux_builders():
            run.main(["first", "--config_path", cfg_path, "--max_steps", "1", "--device", "cpu"])
    finally:
        builtins.open, torch.save = real_open, real_save
    with open(os.path.join(out_dir, f"written{r}.json"), "w") as f:
        json.dump(sorted(set(written)), f)


def test_run_main_on_two_ranks_writes_from_rank_0_alone(tmp_path):
    from test_torch_train_run import TINY, _fixture

    data, log_dir = tmp_path / "data", tmp_path / "logs"
    data.mkdir()
    _fixture(data, n=8)
    cfg = {"log_dir": str(log_dir), "epochs_1st": 1, "batch_size": 4, "max_len": 80,
           "save_freq": 2, "log_interval": 1,
           "data_params": {"train_data": str(data / "train.txt"), "val_data": str(data / "val.txt"),
                           "root_path": str(data), "OOD_data": str(data / "ood.txt"),
                           "min_length": 10},
           "model_params": dict(TINY, slm={"hidden": 48, "nlayers": 3})}
    path = tmp_path / "cfg.yml"
    path.write_text(json.dumps(cfg))  # JSON is YAML
    try:
        mp.spawn(_run_worker, args=(_free_port(), str(path), str(tmp_path)), nprocs=WORLD)
        written = [json.loads((tmp_path / f"written{r}.json").read_text()) for r in range(WORLD)]
        assert written[1] == []
        names = {n.split(".pth.")[0] + ".pth" if ".pth." in n else n for n in written[0]}
        assert {"train.log", "metrics.jsonl", "first_stage.pth", "cfg.yml"} <= names  # .tmp, renamed
        log = (log_dir / "train.log").read_text()
        assert "rank 0 of 2 on cpu, backend gloo, global batch 4" in log
        records = [json.loads(x) for x in (log_dir / "metrics.jsonl").read_text().splitlines()]
        train = [r for r in records if "train/mel" in r]
        assert len(train) == 1 and np.isfinite(train[0]["train/mel"])
    finally:  # ~1 GB at these widths
        for p in log_dir.glob("*.pth"):
            p.unlink()


@pytest.mark.parametrize("world", range(1, 9))
def test_process_shard_is_the_jax_packages(world, monkeypatch):
    import jax

    from styletts2_tpu.parallel import mesh

    monkeypatch.setattr(jax, "process_count", lambda: world)
    for rank in range(world):
        monkeypatch.setattr(jax, "process_index", lambda rank=rank: rank)
        for n in range(51):
            assert ddp.process_shard(n, rank, world) == mesh.process_shard(n)


def test_a_batch_that_does_not_divide_raises():
    assert ddp.local_batch_size(16, 4) == 4
    with pytest.raises(ValueError, match="does not divide"):
        ddp.local_batch_size(6, 4)
