"""The trainers' per-epoch eval artifacts: the stage-1 artifact against the
JAX trainer's `eval_artifacts` at tiny widths (`styletts2_tpu/parallel/tiny.py`),
the stage-2 reconstruction and sampled artifacts, and `run_stage` writing
them (`eval_audio/*.wav`, `eval_attn/attn_step{n}.npy`) and carrying on
when they fail.

The JAX comparison zeroes every random draw and the NSF source's chaotic
STFT phase on both sides (tests/test_torch_stage1.py). Tolerances: the
ground-truth clips are slices of the same wave, equal; the reconstructions
within 1e-3 of their peak, the decoder's bound (test_torch_decoder.py); the
soft attention within 1e-4 (the aligner in f32, test_torch_train_modules.py).
"""

import logging
import types

import jax
import jax.numpy as jnp
import numpy as np
import torch

from styletts2_tpu.models.build import _fi_spectral_align, build_training_models, init_training_params
from styletts2_tpu.parallel.tiny import tiny_config
from styletts2_tpu.train.stage1 import Stage1Trainer as JaxStage1
from styletts2_tpu_torch.config import Config
from styletts2_tpu_torch.convert import state_dict_from_jax
from styletts2_tpu_torch.models import build as pbuild
from styletts2_tpu_torch.models.asr import ASRCNN
from styletts2_tpu_torch.models.jdc import JDCNet
from styletts2_tpu_torch.train import run
from styletts2_tpu_torch.train import stage1 as pstage1
from styletts2_tpu_torch.train.stage2 import Stage2Trainer
from styletts2_tpu_torch.train.state import TrainState
from styletts2_tpu_torch.utils import read_wav
from test_torch_stage1 import _stats
from test_torch_stage2_run import _yaml, small_aux_models  # noqa: F401 (a fixture)
from test_torch_train_run import TINY, _fixture
from torch_parity import _fill, port_cfg, rel_err, stable_har_phase, zero_noise

KEYS = ("text_encoder", "style_encoder", "decoder", "text_aligner", "pitch_extractor")


def _batch(rng):
    return types.SimpleNamespace(
        waves=(0.2 * rng.standard_normal((2, 48000))).astype(np.float32),
        tokens=rng.integers(1, 178, (2, 12)).astype(np.int32),
        input_lengths=np.asarray([12, 9], np.int32), mel_lengths=np.asarray([160, 140], np.int32))


def test_stage1_artifact_matches_jax():
    jcfg = tiny_config()
    models = build_training_models(jcfg)
    shapes = jax.eval_shape(lambda k: init_training_params(models, k, jcfg), jax.random.PRNGKey(0))
    rng = np.random.default_rng(12)
    variables = {}
    for k in KEYS:
        v = {"params": _fill(shapes[k]["params"], rng)}
        if "batch_stats" in shapes[k]:
            v["batch_stats"] = _stats(shapes[k]["batch_stats"], rng)
        if "spectral" in shapes[k]:
            v["spectral"] = _fill(shapes[k]["spectral"], rng)
            _fi_spectral_align(v["spectral"], v["params"])
        variables[k] = v
    variables["decoder"]["params"]["generator"]["conv_post"]["g"] *= 0.1  # exp within f32
    pcfg = port_cfg(jcfg)
    mp = pcfg.model_params
    port = torch.nn.ModuleDict({  # the five modules the forward runs; their weights are JAX's
        "text_encoder": pbuild._text_encoder(pcfg), "style_encoder": pbuild._style_encoder(pcfg),
        "decoder": pbuild._decoder(pcfg), "pitch_extractor": JDCNet(num_class=1),
        "text_aligner": ASRCNN(input_dim=mp.n_mels, n_token=mp.n_token)})
    port.load_state_dict(state_dict_from_jax(variables, pcfg, keys=KEYS))
    batch = _batch(rng)

    jv = jax.tree.map(jnp.asarray, variables)
    ns = types.SimpleNamespace(models=models, mp=False, multispeaker=False, cfg=jcfg)
    ns.state = types.SimpleNamespace(params={k: v["params"] for k, v in jv.items()},
                                     extras={k: {c: x for c, x in v.items() if c != "params"}
                                             for k, v in jv.items()})

    def eval_forward(clip_len):  # the JAX trainer's jitted eval forward
        return jax.jit(lambda p, e, b, s, key: JaxStage1._forward_recon(
            ns, p, e, b, s, s, key, clip_len, use_mono=jnp.asarray(1), train=False))

    ns._eval_forward = eval_forward
    trainer = pstage1.Stage1Trainer(pcfg, TrainState(port, {}), "cpu")
    with zero_noise(), stable_har_phase():
        want = JaxStage1.eval_artifacts(ns, batch, np.random.default_rng(5))
        got = trainer.eval_artifacts(batch, np.random.default_rng(5))
    assert sorted(got["audio"]) == sorted(want["audio"]) == ["gt_0", "gt_1", "y_rec_0", "y_rec_1"]
    for tag in ("gt_0", "gt_1"):
        np.testing.assert_array_equal(got["audio"][tag], want["audio"][tag])
    for tag in ("y_rec_0", "y_rec_1"):
        assert got["audio"][tag].shape == want["audio"][tag].shape
        assert rel_err(got["audio"][tag], want["audio"][tag]) < 1e-3
    assert got["attn"].shape == want["attn"].shape == (12, 80)
    assert rel_err(got["attn"], want["attn"]) < 1e-4


def test_stage2_artifacts(small_aux_models):  # noqa: F811
    """Before joint_epoch: the reconstructions of the first 3 samples beside
    their clips; from it: the first sample synthesised with a sampled style,
    trimmed to its predicted frames, beside its whole utterance."""
    cfg = Config.from_dict({"model_params": TINY, "max_len": 80})
    models = pbuild.build_training_models(cfg, torch.Generator().manual_seed(0), stage="second")
    state = TrainState(models, {}, sigma_data=0.2)
    trainer = Stage2Trainer(cfg, state, "cpu")
    rng = np.random.default_rng(3)
    b = _batch(rng)
    batch = types.SimpleNamespace(**vars(b), wave_lengths=np.asarray([48000, 42000]),
                                  ref_waves=b.waves, ref_wave_lengths=np.asarray([48000, 42000]),
                                  ref_tokens=b.tokens, ref_lengths=b.input_lengths)
    recon = trainer.eval_artifacts(batch, np.random.default_rng(1))
    assert sorted(recon["audio"]) == ["gt_0", "gt_1", "y_rec_0", "y_rec_1"]
    assert all(w.shape == (40 * 600,) and np.isfinite(w).all() for w in recon["audio"].values())
    a = trainer.eval_artifacts(batch, np.random.default_rng(1), sample=True)["audio"]
    again = trainer.eval_artifacts(batch, np.random.default_rng(1), sample=True)["audio"]
    assert sorted(a) == ["gt_0", "sampled_0"]
    np.testing.assert_array_equal(a["gt_0"], batch.waves[0])
    assert len(a["sampled_0"]) > 0 and len(a["sampled_0"]) % 600 == 0
    assert np.isfinite(a["sampled_0"]).all()
    np.testing.assert_array_equal(a["sampled_0"], again["sampled_0"])


def test_run_stage_writes_eval_artifacts(tmp_path, small_aux_models):  # noqa: F811
    data, log_dir = tmp_path / "data", tmp_path / "logs"
    data.mkdir()
    _fixture(data)
    cfg = _yaml(tmp_path / "cfg.yml", log_dir, data)
    run.run_stage("first", str(cfg), max_steps=1, device="cpu")
    audio = sorted(p.name for p in (log_dir / "eval_audio").iterdir())
    assert audio == [f"eval_{t}_{b}_step1.wav" for t in ("gt", "y_rec") for b in (0, 1)]
    for name in audio:
        wav, sr = read_wav(str(log_dir / "eval_audio" / name))
        assert sr == 24000 and len(wav) == 40 * 600 and np.isfinite(wav).all()
    attn = np.load(log_dir / "eval_attn" / "attn_step1.npy")
    assert attn.ndim == 2 and np.isfinite(attn).all() and attn.max() > 0


def test_a_failing_artifact_is_logged_and_training_carries_on(tmp_path, caplog):
    def boom(*a, **k):
        raise RuntimeError("no artifacts today")

    trainer = types.SimpleNamespace(eval_artifacts=boom)
    writer = types.SimpleNamespace()
    logger = logging.getLogger("test_artifacts")
    with caplog.at_level(logging.WARNING, logger="test_artifacts"):
        run.write_eval_artifacts("second", Config(), trainer, [object()], writer, 0,
                                 np.random.default_rng(0), logger)
    assert "eval artifacts failed: RuntimeError: no artifacts today" in caplog.text
    run.write_eval_artifacts("first", Config(), trainer, [], writer, 0,
                             np.random.default_rng(0), logger)  # no validation batch: nothing
