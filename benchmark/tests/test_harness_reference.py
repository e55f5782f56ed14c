"""The plain reference against the port at tiny widths on the CPU: the
batched and the staged entries, both decoders, the voices' styles. (The
test may import the port; the reference may not.)"""

import numpy as np
import pytest
import torch

from benchmark import traffic
from benchmark.reference import synth
from benchmark.reference.model import Reference, param_specs
from benchmark.tests.tiny import tiny_config
from benchmark.weights import make


@pytest.fixture(scope="module", params=[False, True], ids=["istftnet", "hifigan"])
def pair(request):
    from styletts2_tpu_torch.config import Config
    from styletts2_tpu_torch.inference import Synthesizer

    torch.set_num_threads(4)
    cfg = tiny_config(request.param)
    sd = make(param_specs(cfg), 2 ** 31 + 5, "cpu")
    syn = Synthesizer(Config.from_dict(cfg), state_dict=sd, device="cpu", sigma_data=0.2)
    return cfg, syn, Reference(cfg, sd)


def _texts(n, seed):
    import random

    return traffic.texts(n, {"dist": "normal", "mean": 30, "sd": 8, "min": 12, "max": 50},
                         random.Random(seed))


def test_weights_repeat_per_seed_and_load_strictly_into_the_port():
    cfg = tiny_config(True)
    a, b, c = (make(param_specs(cfg), s, "cpu") for s in (1, 1, 2))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["bert_encoder.weight"], c["bert_encoder.weight"])
    from styletts2_tpu_torch.config import Config
    from styletts2_tpu_torch.models.build import build_models

    build_models(Config.from_dict(cfg)).load_state_dict(a)  # strict: every name and shape


def test_batch_as_the_port_serves_it(pair):
    cfg, syn, ref = pair
    texts = _texts(3, 1)
    feats = None
    if ref.multispeaker:
        wave = traffic.voice_waves({"voices": {"count": 1, "zipf_s": 1.0, "seconds": 1.5}}, 4)["v00"]
        st, rs = syn.compute_style(wave), ref.style(wave).numpy()
        assert np.abs(st - rs).max() <= 1e-5 * np.abs(rs).max()
        feats = np.concatenate([rs] * 3)
    speed = synth.speed_for(ref, texts, 2.8, 9, 0.2, feats)
    assert speed > 2.0
    wavs = syn.inference_batch(texts, ref_s=feats, speed=speed, seed=0)
    trim = 50 if ref.multispeaker else 0
    rows = synth.synthesize(ref, texts, feats, alpha=0.3, beta=0.7, steps=5, scale=1.0,
                            speed=speed, seed=0, sigma_data=0.2,
                            served_frames=[(len(w) + trim) // 600 for w in wavs], wav16=False)
    for w, row in zip(wavs, rows):
        assert len(row.candidates) >= 1
        c = row.candidates[0]
        assert len(c) == len(w)
        assert np.abs(w - c).max() <= 1e-4 * np.abs(c).max()


def test_single_as_the_port_synthesizes_it(pair):
    cfg, syn, ref = pair
    if ref.multispeaker:
        pytest.skip("the staged single entry is the single-speaker cell's")
    text = _texts(1, 2)[0]
    w, _ = syn.inference(text, speed=4.0)
    rows = synth.synthesize(ref, [text], None, alpha=0.3, beta=0.7, steps=5, scale=1.0,
                            speed=4.0, seed=0, sigma_data=0.2, served_frames=[len(w) // 600],
                            wav16=False)
    assert np.abs(w - rows[0].candidates[0]).max() <= 1e-4 * np.abs(w).max()


def test_near_ties_are_rounded_both_ways():
    dur = np.array([3.2, 7.4995, 2.5004, 5.0])
    cands = synth._candidates(dur, 1.0, True)
    assert [list(c) for c in cands] == [[3, 7, 3, 10], [3, 7, 2, 10], [3, 8, 3, 10], [3, 8, 2, 10]]
    assert [list(c) for c in synth._candidates(dur, 1.0, False)][0] == [3, 7, 3, 5]
    # after the speed a flip that rounds alike is one candidate
    assert len(synth._candidates(np.array([24.4998, 9.0]), 8.0, False)) == 1


def _f0_nudged_gap(cfg, sd):
    """The reference against itself with its F0 curve moved by one part in a
    million: the widest gap over the batch's rows, and the F0 curve's peak."""
    ref = Reference(cfg, sd)
    texts = _texts(3, 3)
    toks = [synth.encode(t) for t in texts]
    lengths = torch.tensor([len(t) for t in toks])
    tokens = torch.zeros((3, 64), dtype=torch.int64)
    for i, t in enumerate(toks):
        tokens[i, : len(t)] = torch.from_numpy(t)
    D = 2 * ref.sdim
    gen = torch.Generator().manual_seed(0)
    with torch.inference_mode():
        t_en, d, s, rs, dur = ref.phase_a(tokens, lengths, torch.zeros((3, 1, D)),
                                          torch.zeros((3, D)), 0.3, 0.7, 5, 1.0, gen, 0.2)
        after = gen.get_state()
        pd = torch.clamp(torch.round(torch.clamp(torch.round(dur), min=1) / 4.0), min=1).long()
        asr, f0, n = ref.prosody(t_en, d, s, pd, 100 * -(-int(pd.sum(1).max()) // 100))
        out = []
        for nudge in (1.0, 1.0 + 1e-6):
            gen.set_state(after)
            out.append(ref.decode(asr, f0 * nudge, n, rs, gen).numpy())
    gap = max(np.abs(a - b).max() / np.abs(a).max() for a, b in zip(*out))
    return gap, float(f0.max())


def test_the_drawn_f0_keeps_every_row_unvoiced_where_a_comparison_holds():
    """A row with a sample over the sine source's 10 Hz threshold moves by
    a large share of its peak when F0 moves by 1e-6; the drawn weights keep
    F0 an order under it, where the same nudge moves nothing."""
    from benchmark.reference import model

    torch.set_num_threads(4)
    cfg = tiny_config(False)
    sd = make(param_specs(cfg), 7, "cpu")
    gap, peak = _f0_nudged_gap(cfg, sd)
    assert peak < 0.1 * 10.0 and gap < 1e-5
    voiced = {k: v * (20.0 / model.F0_GAIN) if k.startswith("predictor.F0_proj.") else v
              for k, v in sd.items()}
    gap, peak = _f0_nudged_gap(cfg, voiced)
    assert peak > 10.0 and gap > 1e-2
