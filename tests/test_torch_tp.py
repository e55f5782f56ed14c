"""Tensor parallelism over a 'model' axis (`styletts2_tpu_torch/parallel/mesh.py`)
on the CPU: gloo processes (`torch.multiprocessing.spawn`, a rendezvous
file per group) at tests/torch_tiny_train.py's tiny widths, against one
process, as tests/test_torch_ddp.py holds data parallelism.

- 2 ranks at model parallel 2 (data 1), each on the 8-utterance global
  batch, and 4 ranks as data 2 x model 2, each data rank on 4 of them: a
  stage-1 TMA step and a stage-2 joint step each compute what one process
  computes on the global batch (each group's rank 0 runs that process's
  step itself after its own). The draws are made the same for every row,
  TPRLS's median picked on rounded values and the NSF source's STFT phase
  zeroed, as tests/test_torch_ddp.py does, and held to its tolerances
  (`check_as_one_process`: losses within 1e-5 relative, every stepped
  module's gradient within 1e-3 of its norm, the SLM pass's late steps
  within 1e-1, the weights after the step within 1e-6 but for Adam's sign
  flips); the AdamW moments after the step, gathered, within MOMENT_REL of
  one process's per module (LATE_GRAD_REL for the modules the late steps
  move); every rank of a group holds the same bits. Measured here:
  gradients <= 1.1e-4 (model parallel 2: 1.0e-5), the late steps' <=
  1.5e-2, moments as the gradients.
- A checkpoint written from the sharded state equals the one written from
  the same weights and moments unsharded (bit-equal), reads back into
  sharded modules as this rank's slices (bit-equal), gathers back to the
  full modules, and the JAX package's `convert_styletts2_checkpoint` reads
  it as it reads the unsharded one.
- The layout at full width (modules on the meta device): PL-BERT's FFN,
  the denoiser's mapping, attention and FFN and WavLM's FFN sharded; every
  other weight the JAX rule would shard has its reason.
- A world that k does not divide raises.
"""

import copy
import hashlib
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from styletts2_tpu_torch.parallel import ddp, mesh
from styletts2_tpu_torch.train import stage1 as pstage1
from styletts2_tpu_torch.train import stage2 as pstage2
from styletts2_tpu_torch.train.state import (TrainState, build_optimizers, load_checkpoint,
                                             snapshot, write_payload)
from test_torch_ddp import (LATE_GRAD_REL, STAGES, _case, _global_batch, _shard,
                            check_as_one_process, rows_alike_draws, stable_har_phase,
                            stable_median)

GROUPS = {"mp2": (2, 2), "dp2mp2": (4, 2)}  # name: (world, model parallel)
MOMENT_REL = 1e-3
JAX_READ = ("bert", "bert_encoder", "diffusion", "predictor", "text_encoder")
JAX_RULE_SIDE = 1024  # `styletts2_tpu/parallel/mesh.py:param_pspec`


def full_gradient(module):
    """The module's gradient flattened in `parameters()` order, zeros where
    none arrived, every shard gathered to its full tensor (a collective of
    the model group where the module is sharded)."""
    sharded = mesh.sharded_parameters(module)
    parts = []
    for n, p in module.named_parameters():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        parts.append((sharded[n][0].gather(g, sharded[n][1]) if n in sharded else g).detach()
                     .flatten())
    return torch.cat(parts)


def jax_rule_names(models):
    """The 2-D parameters the JAX rule shards (a side of JAX_RULE_SIDE or
    more), by the port's names."""
    return [f"{k}.{n}" for k, m in models.items() for n, p in m.named_parameters()
            if p.dim() == 2 and max(p.shape) >= JAX_RULE_SIDE]


def replicated_reasons(models):
    """{name: why it stays replicated} of each parameter the JAX rule shards
    and the layout does not (parallel/mesh.py's docstring); "" where no
    reason applies (a gap)."""
    from styletts2_tpu_torch.models.diffusion.denoiser import Transformer1d
    from styletts2_tpu_torch.models.layers import StyleAffine

    laid = {f"{n}.weight" for pair in mesh.plan(models) for n in mesh._names(pair)}
    reasons = {}
    for k, module in models.items():
        kinds = {}
        for name, sub in module.named_modules():
            if isinstance(sub, (torch.nn.LSTM, torch.nn.LSTMCell)):
                kinds[name] = "LSTM gates: a gate split needs a collective in every time step"
            elif isinstance(sub, StyleAffine):
                kinds[f"{name}.fc"] = ("style affine: one row per item, too small to pay for "
                                       "the collective")
            elif isinstance(sub, Transformer1d):
                for head in ("to_time", "to_features"):
                    kinds[f"{name}.{head}" if name else head] = (
                        "denoiser time/feature input: one row per item, too small to pay for "
                        "the collective")
        for n, p in module.named_parameters():
            full = f"{k}.{n}"
            if p.dim() != 2 or max(p.shape) < JAX_RULE_SIDE or full in laid:
                continue
            reasons[full] = next((why for prefix, why in kinds.items()
                                  if n.startswith(prefix + ".") or (not prefix)), "")
    return reasons


def per_rank(models, k):
    """Parameters in all, sharded by the layout, and held by each of k
    ranks (unsharded `models`; sides k does not divide stay whole)."""
    total = sum(p.numel() for p in models.parameters())
    sharded = 0
    for pair in mesh.plan(models):
        if pair.side % k:
            continue
        owner = mesh._get(models[pair.key], pair.owner)
        for path, dim, _ in pair.members:
            lin = mesh._get(owner, path)
            sharded += lin.weight.numel() + (lin.bias.numel() if lin.bias is not None and dim == 0
                                             else 0)
    return {"total": total, "sharded": sharded, "per_rank": total - sharded + sharded // k}


def _step(stage, batch, shard):
    """One train_step of `stage` from _case's modules, sharded when `shard`:
    {"metrics", "grads" (full), "state" (full), "moments" ({module: its
    gathered exp_avg and exp_avg_sq, flattened})}."""
    trainer_cls, cfg, models, epoch = _case(stage)
    models = copy.deepcopy(models)
    if shard:
        mesh.shard_(models)
    stage1 = trainer_cls is pstage1.Stage1Trainer
    state = TrainState(models, build_optimizers(cfg, models, stage2=not stage1), sigma_data=0.2)
    module, grads = (pstage1 if stage1 else pstage2), []
    step_modules = module.step_modules

    def spy(ms, opts, keys):
        grads.append({k: full_gradient(ms[k]) for k in keys})
        step_modules(ms, opts, keys)

    module.step_modules = spy
    try:
        with stable_har_phase(), rows_alike_draws(), stable_median():
            torch.manual_seed(0)
            metrics = trainer_cls(cfg, state, "cpu").train_step(batch, epoch, 0,
                                                                np.random.default_rng(3))
    finally:
        module.step_modules = step_modules
    payload = snapshot(state)
    moments = {}
    for k, opt in payload["optimizer"].items():
        st = opt["state"]
        if st:
            moments[k] = torch.cat([st[i][m].flatten() for i in sorted(st)
                                    for m in ("exp_avg", "exp_avg_sq")])
    return {"metrics": ddp.mean_metrics(metrics), "grads": grads, "moments": moments,
            "state": {f"{k}.{n}": v for k, sd in payload["net"].items() for n, v in sd.items()}}


def _moved(state):
    """A deterministic step of every optimizer (gradient 0.5 w + 0.01), so
    the moments are not zero."""
    for k, opt in state.opts.items():
        for p in state.models[k].parameters():
            p.grad = 0.5 * p.detach() + 0.01
        opt.step()
        opt.zero_grad(set_to_none=True)


def _checkpoint(out_dir):
    """Rank 0 writes the sharded and the unsharded snapshot of the same
    weights and moments; every rank reads the sharded file back into fresh
    sharded modules. Returns {"equal": the two snapshots bit-equal, "local":
    the read-back shards bit-equal to this rank's slices, "gathered": the
    read-back modules, gathered, bit-equal to the full ones}."""
    _, cfg, models, _ = _case("second")
    full_models = copy.deepcopy(models)
    full = TrainState(full_models, build_optimizers(cfg, full_models, stage2=True), sigma_data=0.2)
    sharded_models = copy.deepcopy(models)
    names = mesh.shard_(sharded_models)
    sharded = TrainState(sharded_models, build_optimizers(cfg, sharded_models, stage2=True),
                         sigma_data=0.2)
    _moved(full)
    _moved(sharded)
    a, b = snapshot(sharded), snapshot(full)
    equal = _same(a, b)
    path = os.path.join(out_dir, "payload.pth")
    if dist.get_rank() == 0:
        write_payload(path, a)
    dist.barrier()
    back_models = copy.deepcopy(models)
    mesh.shard_(back_models)
    back = TrainState(back_models, build_optimizers(cfg, back_models, stage2=True))
    load_checkpoint(path, back)
    local = all(torch.equal(v, sharded_models[k].state_dict()[n])
                for k in sharded_models for n, v in back_models[k].state_dict().items())
    local = local and _same({"o": {k: o.state_dict() for k, o in back.opts.items()}},
                            {"o": {k: o.state_dict() for k, o in sharded.opts.items()}})
    mesh.gather_(back_models)
    gathered = all(torch.equal(v, full.models[k].state_dict()[n])
                   for k in full.models for n, v in back_models[k].state_dict().items())
    gathered = gathered and all(
        back_models[k].state_dict()[n].shape == v.shape
        for k in full.models for n, v in full.models[k].state_dict().items())
    dist.barrier()
    if dist.get_rank() == 0:  # the modules the JAX converter reads, for the main process
        for name, payload in (("sharded.pth", a), ("unsharded.pth", b)):
            torch.save({"net": {k: payload["net"][k] for k in JAX_READ}},
                       os.path.join(out_dir, name))
        os.remove(path)
    return {"equal": equal, "local": local, "gathered": gathered, "sharded": names}


def _same(a, b):
    if isinstance(a, dict):
        return isinstance(b, dict) and sorted(a, key=str) == sorted(b, key=str) and all(
            _same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if torch.is_tensor(a):
        return torch.is_tensor(b) and a.shape == b.shape and torch.equal(a, b)
    return a == b


def _digest(result):
    """A hash of a step's metrics, gathered weights and moments: ranks that
    hold the same bits hash alike."""
    h = hashlib.sha256(repr(sorted(result["metrics"].items())).encode())
    for part in (result["state"], result["moments"]):
        for k in sorted(part):
            h.update(part[k].contiguous().numpy().tobytes())
    return h.hexdigest()


def _compare(stage, got, want):
    """`check_as_one_process` of one rank's step against one process's, and
    the gathered AdamW moments per module: {"grads", "moments"}, the errors."""
    grad_err = check_as_one_process(stage, [got], want)
    late = 2 if stage == "second" else len(want["grads"])
    late_keys = {key for s in want["grads"][late:] for key in s}
    moment_err = {key: float((got["moments"][key] - v).norm() / max(float(v.norm()), 1e-30))
                  for key, v in want["moments"].items()}
    for key, err in moment_err.items():
        assert err <= (LATE_GRAD_REL if key in late_keys else MOMENT_REL), (key, err)
    return {"grads": [e for (i, _), e in grad_err.items() if i < late],
            "late": [e for (i, _), e in grad_err.items() if i >= late],
            "moments": {k: e for k, e in moment_err.items() if k not in late_keys},
            "late_moments": {k: e for k, e in moment_err.items() if k in late_keys}}


def _worker(i, out_dir):
    """Processes 0-1: the model-parallel pair; 2-5: data 2 x model 2. Each
    group's rank 0 then runs one process's step on the global batch itself
    and compares (a step's tensors are ~1 GB at these widths: nothing but
    the errors and each rank's digest is written)."""
    torch.set_num_threads(1)
    name = "mp2" if i < 2 else "dp2mp2"
    world, k = GROUPS[name]
    r = i if i < 2 else i - 2
    dist.init_process_group("gloo", init_method=f"file://{out_dir}/rdv_{name}", rank=r,
                            world_size=world)
    try:
        m = mesh.make_mesh(world, k)
        batch = _global_batch() if m.data == 1 else _shard(_global_batch(), m.data_rank)
        steps = {s: _step(s, batch, True) for s in STAGES}
        out = {"mesh": (m.data, m.model, m.data_rank, m.model_rank),
               "digest": {s: _digest(v) for s, v in steps.items()}}
        if name == "mp2":
            out["checkpoint"] = _checkpoint(out_dir)
    finally:
        mesh.reset()
        dist.destroy_process_group()
    if r == 0:
        out["errors"] = {s: _compare(s, steps[s], _step(s, _global_batch(), False))
                         for s in STAGES}
    torch.save(out, os.path.join(out_dir, f"{name}_rank{r}.pt"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{group name: [each rank's {"mesh", "digest", ...}]}, the dir."""
    d = tmp_path_factory.mktemp("tp")
    mp.spawn(_worker, args=(str(d),), nprocs=sum(w for w, _ in GROUPS.values()))
    load = lambda name: torch.load(d / name, weights_only=False)  # noqa: E731
    return {g: [load(f"{g}_rank{r}.pt") for r in range(w)] for g, (w, _) in GROUPS.items()}, d


@pytest.mark.parametrize("stage", STAGES)
@pytest.mark.parametrize("group", list(GROUPS))
def test_model_parallel_step_as_one_process(group, stage, runs):
    groups, _ = runs
    world, k = GROUPS[group]
    ranks = groups[group]
    assert [r["mesh"] for r in ranks] == [(world // k, k, i // k, i % k) for i in range(world)]
    assert len({r["digest"][stage] for r in ranks}) == 1  # every rank holds the same bits
    e = ranks[0]["errors"][stage]
    print(f"{group} {stage}: gradients {max(e['grads']):.1e}, late "
          f"{max(e['late'], default=0):.1e}; moments {max(e['moments'].values()):.1e}, "
          f"late {max(e['late_moments'].values(), default=0):.1e}")


def test_sharded_checkpoint_is_the_unsharded_one(runs):
    from styletts2_tpu.convert import convert_styletts2_checkpoint
    from styletts2_tpu.parallel.tiny import tiny_config as jax_tiny_config

    groups, d = runs
    for r in groups["mp2"]:
        c = r["checkpoint"]
        assert c["equal"] and c["local"] and c["gathered"], c
    names = groups["mp2"][0]["checkpoint"]["sharded"]
    assert {n.split(".")[0] for n in names} == {"bert", "diffusion", "wavlm"}
    assert any(n.endswith("ffn") for n in names) and any(n.endswith("to_kv") for n in names)
    jcfg = jax_tiny_config()
    converted = []
    for name in ("sharded.pth", "unsharded.pth"):
        net = torch.load(d / name, weights_only=True)["net"]
        keys = sorted(net)
        converted.append(convert_styletts2_checkpoint(
            {"net": {k: {n: v.numpy() for n, v in net[k].items()} for k in keys}}, jcfg))
    import jax
    leaves = [jax.tree_util.tree_leaves_with_path(c) for c in converted]
    assert len(leaves[0]) == len(leaves[1]) > 0
    for (pa, a), (pb, b) in zip(*leaves):
        assert pa == pb
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("config", ["ljspeech", "libritts"])
def test_layout_at_full_width(config):
    from styletts2_tpu_torch.config import Config, libritts_config
    from styletts2_tpu_torch.models.build import build_training_models

    with torch.device("meta"):
        models = build_training_models((Config if config == "ljspeech" else libritts_config)(),
                                       stage="second")
    laid = {n for pair in mesh.plan(models) for n in mesh._names(pair)}
    for want in ("bert.encoder.albert_layer_groups.0.albert_layers.0.ffn",
                 "bert.encoder.albert_layer_groups.0.albert_layers.0.ffn_output",
                 "diffusion.to_mapping.0", "diffusion.to_mapping.2",
                 "diffusion.blocks.2.attention.to_q", "diffusion.blocks.2.attention.to_kv",
                 "diffusion.blocks.2.attention.attention.to_out",
                 "diffusion.blocks.2.feed_forward.0", "diffusion.blocks.2.feed_forward.2",
                 "wavlm.encoder.layers.11.feed_forward.intermediate_dense",
                 "wavlm.encoder.layers.11.feed_forward.output_dense"):
        assert want in laid, want
    reasons = replicated_reasons(models)
    assert all(reasons.values()), {k: v for k, v in reasons.items() if not v}
    jax_rule = set(jax_rule_names(models))
    assert set(reasons) == jax_rule - {f"{n}.weight" for n in laid}
    counts = per_rank(models, 2)
    print(f"{config}: {counts['total']} parameters, {counts['sharded']} sharded, "
          f"{counts['per_rank']} per rank at model parallel 2; the JAX rule's "
          f"{len(jax_rule)} tensors, {len(reasons)} kept replicated")
    assert counts["sharded"] > 0.25 * counts["total"]


def test_a_world_that_model_parallel_does_not_divide_raises(monkeypatch):
    with pytest.raises(ValueError, match="does not divide"):
        mesh.make_mesh(3, 2)
    with pytest.raises(ValueError, match="does not divide"):
        mesh.make_mesh(4, 3)
    assert mesh.make_mesh(1, 1) == mesh.Mesh()
    monkeypatch.setenv(mesh.MODEL_PARALLEL_ENV, "2")
    assert mesh.model_parallel_from_env() == 2
    from styletts2_tpu_torch.train import run

    with pytest.raises(ValueError, match="does not divide a world of 1"):
        run.run_stage("first", _case("first")[1], max_steps=1, device="cpu")
