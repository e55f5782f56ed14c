"""The port's batched multispeaker synthesis, `inference_batch`, against
the JAX `inference_batch` at tiny widths: three texts of mixed lengths,
each with its own reference style, padded to one text bucket and one frame
bucket. The decoder's instance norms see the padded frames on both sides,
so the JAX batch, not the single-item path, is the reference.

Random draws and the NSF source's sines are zeroed on both sides
(`zero_noise`, `zero_sines`, as test_torch_multispeaker.py). Tolerances:
equal lengths (the durations' sums) and each waveform within 1e-3 of its
peak, the decoder's bound.
"""

import numpy as np
import torch

from styletts2_tpu_torch.convert import state_dict_from_jax
from torch_parity import jax_models_and_params, jax_ms_cfg, port_cfg, rel_err, zero_noise, zero_sines

TEXTS = ["ðɪs ɪz ɐ tˈɛst ʌv ðə pˈɔːɹt.", "hˈɛloʊ.", "ɐ ʃˈɔːɹt wˈʌn."]


def test_inference_batch_matches_jax():
    from styletts2_tpu.inference import Synthesizer as JaxSynthesizer
    from styletts2_tpu_torch.inference import Synthesizer

    jcfg = jax_ms_cfg()
    _, params = jax_models_and_params(jcfg, seed=31)
    jsyn = JaxSynthesizer(jcfg, params=params)
    psyn = Synthesizer(port_cfg(jcfg), state_dict=state_dict_from_jax(params, port_cfg(jcfg)),
                       device="cpu")
    refs = np.random.default_rng(32).standard_normal((3, 2 * psyn.style_dim)).astype(np.float32)
    lengths = []
    run = psyn._run

    def spy(toks, *a):  # records each item's durations
        out = run(toks, *a)
        lengths.extend(int(d.sum()) * 600 - 50 for d in out.pred_dur)
        return out

    psyn._run = spy
    with zero_noise(), zero_sines():
        want = jsyn.inference_batch(TEXTS, ref_s=refs, embedding_scale=1.5, speed=4.0)
        got = psyn.inference_batch(TEXTS, ref_s=refs, embedding_scale=1.5, speed=4.0)
    assert len(got) == len(want) == 3
    assert len({len(w) for w in got}) == 3  # mixed lengths
    for g, w, n in zip(got, want, lengths):
        assert g.shape == w.shape == (n,)
        assert np.isfinite(g).all()
        assert rel_err(g, w) < 1e-3


@torch.inference_mode()
def test_batch_rows_are_independent_of_order():
    """Reordering the batch reorders the waveforms and changes none: every
    op is per item, the padding is masked or decoded alike."""
    from styletts2_tpu_torch.inference import Synthesizer

    jcfg = jax_ms_cfg()
    psyn = Synthesizer(port_cfg(jcfg), seed=33, device="cpu")
    refs = np.random.default_rng(34).standard_normal((3, 2 * psyn.style_dim)).astype(np.float32)
    with zero_noise():
        a = psyn.inference_batch(TEXTS, ref_s=refs, diffusion_steps=3, speed=8.0)
        b = psyn.inference_batch(TEXTS[::-1], ref_s=refs[::-1], diffusion_steps=3, speed=8.0)
    for x, y in zip(a, b[::-1]):
        assert x.shape == y.shape
        assert rel_err(x, y) < 1e-5
