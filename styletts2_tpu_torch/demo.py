"""Demo CLI, the packaged counterpart of the reference inference notebooks
(`styletts2_tpu/demo.py`), on the PyTorch port:

    python -m styletts2_tpu_torch.demo --text "ðɪs ɪz ɐ tˈɛst." --out out.wav \\
        [--config configs/config.yml] [--ckpt epochs_2nd_00020.pth] \\
        [--ref_wav speaker.wav] [--steps 5] [--scale 1.0] [--longform] [--device cuda]

`--ckpt` is a StyleTTS 2 checkpoint, the reference's own `.pth` or one of
the port's trainers (`serve.load_synthesizer`); without it the weights are
random, drawn from `--seed`, which also seeds the sampler's draws. The text
is pre-phonemized IPA. `--ref_wav` (multispeaker) is resampled to 24 kHz by
linear interpolation. It runs on the card unless `--device cpu` asks for
the CPU, with convolutions and matmuls in f32.
"""

from __future__ import annotations

import argparse
import logging
import time

SR = 24000


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--text", required=True, help="pre-phonemized IPA text")
    ap.add_argument("--out", default="out.wav")
    ap.add_argument("--config", default=None)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ref_wav", default=None, help="reference speaker wav (multispeaker)")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--alpha", type=float, default=0.3)
    ap.add_argument("--beta", type=float, default=0.7)
    ap.add_argument("--longform", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    return ap.parse_args(argv)


def main(argv=None):
    from styletts2_tpu_torch.serve import load_synthesizer
    from styletts2_tpu_torch.utils import read_wav, resample_linear, set_f32_compute, write_wav

    logging.basicConfig(level=logging.INFO, format="%(message)s")
    args = parse_args(argv)
    set_f32_compute()
    syn = load_synthesizer(args.config, args.ckpt, args.device, seed=args.seed)
    ref_s = None
    if args.ref_wav:
        wave, sr = read_wav(args.ref_wav)
        ref_s = syn.compute_style(resample_linear(wave, sr, SR))

    t0 = time.time()
    if args.longform:
        wav = syn.long_form(args.text, ref_s=ref_s, diffusion_steps=args.steps,
                            embedding_scale=args.scale)
    else:
        wav, _ = syn.inference(args.text, ref_s=ref_s, alpha=args.alpha, beta=args.beta,
                               diffusion_steps=args.steps, embedding_scale=args.scale,
                               seed=args.seed)
    dt = time.time() - t0
    rtf = (len(wav) / SR) / dt
    write_wav(args.out, wav, SR)
    print(f"wrote {args.out}: {len(wav) / SR:.2f}s audio in {dt:.2f}s "
          f"(RTF {rtf:.2f}x, incl. compile on first call)")


if __name__ == "__main__":
    main()
