"""How far a 1e-7 relative change of the weights moves each module's
gradient in `chip_smoke.py`'s reduced-width stage-2 reference step (phases
14 and 19), on the CPU: the conditioning that bounds any card-vs-CPU
comparison of the step.

    python3 tools/conditioning_torch.py [--source noise|zero|sines] [--istftnet] [--seed 5]
                                        [--threads N]

The step is phase 19's (multispeaker, HiFi-GAN; `--istftnet`: phase 14's,
its source as phase 14 runs it): the same weights, batch, clip starts and
host draws. `--source` picks the HiFi-GAN source: `noise` (the sines
zeroed and the noise kept, as phase 19 runs it), `zero` (the whole source
zeroed: a constant excitation, whose instance norms then normalise
rounding) or `sines` (the live source). `--seed` draws the change of the
weights. `--threads N` changes no weight and reruns the step on N CPU
threads instead of 4: the movement that the order of the sums alone makes.
It prints each module's relative L2 movement. CPU only; ~20 s.
"""

import argparse
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", choices=("noise", "zero", "sines"), default="noise")
    ap.add_argument("--istftnet", action="store_true")
    ap.add_argument("--seed", type=int, default=5, help="the draw of the change of the weights")
    ap.add_argument("--threads", type=int, default=None,
                    help="rerun on this many threads instead of changing the weights")
    args = ap.parse_args(argv)
    torch.set_num_threads(4)
    cfg, models, batch, starts = cs.stage2_reference_case(libritts=not args.istftnet)
    kw = {} if args.istftnet else {"noise_source": args.source == "noise",
                                   "zero_sines": args.source == "zero"}

    def grads():
        return cs._host_draws(cs._stage2_losses_and_grads, models, cfg, "cpu", batch, starts,
                              **kw)[1]

    before = grads()
    if args.threads is None:
        g = torch.Generator().manual_seed(args.seed)
        with torch.no_grad():
            for p in models.parameters():
                p.mul_(1 + 1e-7 * torch.randn(p.shape, generator=g))
        change = f"a 1e-7 change of the weights (seed {args.seed})"
    else:
        torch.set_num_threads(args.threads)
        change = f"{args.threads} threads instead of 4"
    after = grads()
    print(f"{'iSTFTNet' if args.istftnet else 'source ' + args.source}: {change} moves each "
          "gradient by (L2, relative)")
    for k, v in before.items():
        print(f"  {k}: {float((after[k] - v).norm() / v.norm()):.2e}")


if __name__ == "__main__":
    main()
